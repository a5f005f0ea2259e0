"""Code-mixed data augmentation (CDM) — MUSE-dictionary word-level
translation of English questions into target languages at data-load time
(own copy of clg_vqa_tpu/data/code_mix.py).

Reproduces the reference algorithm (gqa_dataset_semantic_code_mix.py:659-681,
datasets/code_mixing.py):

 - per question: with prob ``ratio``, each whitespace token is considered
 - per token: with prob ``cross``, pick a uniform random target language and
   look the lowercased token up in that language's MUSE dict; replace with a
   uniform random translation if present
 - the ``' ?' -> '?'`` fixup after joining (line 621-622)

RNG note (documented divergence): the reference reseeds
random/numpy/torch with the SAME seed inside every preprocessing call
(gqa_dataset_semantic_code_mix.py:566-571), which makes the code-mix
decision sequence identical for every sample. We default to a per-sample
derived seed (the statistically intended behavior); pass
``reference_reseed=True`` to reproduce the quirk bit-for-bit.
"""
from __future__ import annotations

import glob
import os
import random

MUSE_LANGS = ("bn", "de", "id", "ko", "pt", "ru", "zh")


def load_muse_dicts(dict_path: str) -> dict:
    """{"languages": [...], "src2tgt": [per-language dict of src ->
    [translations]]} — same structure as the reference's load_worddict
    (gqa_dataset_semantic_code_mix.py:455-477). Lines are 'src\\ttgt' or
    'src tgt'."""
    languages, src2tgt = [], []
    for file in sorted(glob.glob(f"{dict_path}/*.txt")):
        languages.append(os.path.basename(os.path.normpath(file))[:2])
        d: dict[str, list[str]] = {}
        with open(file, encoding="utf8") as reader:
            for line in reader:
                line = line.rstrip("\n")
                if not line:
                    continue
                if "\t" in line:
                    src, tgt = line.split("\t", 1)
                else:
                    parts = line.split(" ", 1)
                    if len(parts) != 2:
                        continue
                    src, tgt = parts
                d.setdefault(src, []).append(tgt)
        src2tgt.append(d)
    return {"languages": languages, "src2tgt": src2tgt}


class CodeMixer:
    def __init__(self, word_dicts: dict, *, ratio: float = 1.0,
                 cross: float = 0.9, seed: int = 0,
                 reference_reseed: bool = False):
        self.word_dicts = word_dicts
        self.ratio = ratio
        self.cross = cross
        self.seed = seed
        self.reference_reseed = reference_reseed

    def __call__(self, question: str, sample_key: int = 0) -> str:
        if self.reference_reseed:
            # bit-for-bit quirk reproduction: the reference reseeds TWO
            # global streams per preprocessing call (random.seed +
            # np.random.seed, gqa_dataset_semantic_code_mix.py:566-571)
            # and draws the ratio/cross gates from NUMPY while language
            # and candidate indices come from PYTHON random
            # (lines 660-678) — a single stream would pick different
            # languages/candidates
            import numpy as _np
            np_rng = _np.random.RandomState(self.seed)
            py_rng = random.Random(self.seed)
            gate = np_rng.rand
            pick = py_rng.randint
        else:
            rng = random.Random((self.seed << 32) ^ hash(sample_key) & 0xFFFFFFFF)
            gate = rng.random
            pick = rng.randint
        mixed = []
        n_langs = len(self.word_dicts["languages"])
        for token in question.split():
            # every considered token is LOWERCASED in the output whether or
            # not a translation is found (cross_list passes xx.lower() into
            # do_code_mix, which returns it unchanged on miss; line 671-678)
            token = token.lower()
            # per-token draws: sentence-level gate (ratio) then token-level
            # (cross) — the reference draws both per token; the cross gate
            # is short-circuited when ratio fails (do_code_mix's `not
            # disable and ...`)
            if self.ratio >= gate() and self.cross >= gate():
                lan = pick(0, n_langs - 1)
                lut = self.word_dicts["src2tgt"][lan]
                if token in lut:
                    cands = lut[token]
                    token = cands[pick(0, len(cands) - 1)]
            mixed.append(token)
        return " ".join(mixed).replace(" ?", "?")
