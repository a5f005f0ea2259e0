"""Model families: what the benchmark knows of a model, one module a
family, ``portbench/families/<model_name>.py``, found by the configuration
file's ``model_name`` and loaded from its path (harness/manifest.family).
Adding a family adds files only: its module, its plain reference under
``portbench/reference/``, a configuration, and the cells that run it.

A family module provides:

- ``dims(cfg) -> dict``: the numbers the harness needs, read from the
  configuration file. Shared keys, which the kinds, the reference's data
  path, the traffic generator and the readers use: ``model`` (the
  ``model_name``), ``text``, ``regions``, ``feat``, ``locs``, ``norm``,
  ``vocab``, ``pad``, ``labels``, ``H``, ``heads``, ``layers``,
  ``max_pos``; a family adds what it needs beyond them.
- ``layout(d)``: [(name, shape, init)] of every weight, in draw order, by
  the port's checkpoint names (harness/weights.make_weights).
- ``model(cfg_path, d, weights, device)``: the port's model built from the
  configuration file, holding ``weights`` by name (harness/program.holding).
- ``forward_flops(d)``: matrix and attention FLOPs of one sample's forward.
- ``reference``: the family's plain fp32 module under
  ``portbench/reference/``, with ``forward(cfg, w, batch, *, seed, prec)``
  and ``decays(name)``; it imports nothing of the port and nothing of JAX.
- ``tiny(cfg)``: the configuration shrunk to a size the CPU tests run in
  seconds, the same code paths."""
