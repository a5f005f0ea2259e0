"""The plain fp32 reference of the benchmark's cells: each model family's
module (``model.py``: UC2 and M3P as published), the GQA loss with its
semantic prior, gradient accumulation, the clip and pytorch_transformers'
AdamW, and the dropout masks worked out again from the step's seed. Plain
``torch`` only: it imports nothing of the program under test, and nothing
of JAX."""
