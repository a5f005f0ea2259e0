"""Semantic-prior generators (own copy of clg_vqa_tpu/data/prior.py) —
rebuilds of volta/extract_wn_rel.py and
volta/extract_emb_dist.py that produce both the reference pickle formats and
dense distance matrices directly.

 - WordNet relations: per label, synonyms / hypernyms / hyponyms over the
   answer vocabulary (space -> underscore/hyphen fallbacks as in
   extract_wn_rel.py:16-27). Gated on the nltk wordnet corpus being
   installed.
 - Embedding distances: 1 - cosine similarity between label phrase vectors.
   The reference uses spaCy's en_core_web_lg doc.similarity (= cosine of the
   mean token vector); here any word->vector mapping works (e.g. GloVe text
   files), with the same mean-of-tokens semantics.
"""
from __future__ import annotations

import pickle

import numpy as np


def build_wordnet_relations(label2ans: list[str]) -> dict[int, dict]:
    """-> {label_index: {"syn": [...], "hyp": [...], "hpo": [...]}}
    (the l2l_semantic_index.pkl format)."""
    from nltk.corpus import wordnet  # gated: needs the corpus download

    def get_syn_hyper(word: str):
        syns, hyps, hpos = set(), set(), set()
        w = word.replace(" ", "_")
        if not wordnet.synsets(w):
            w = word.replace(" ", "-")
        for syn in wordnet.synsets(w):
            syns.update(syn.lemma_names())
            for h in syn.hypernyms():
                hyps.update(h.lemma_names())
            for h in syn.hyponyms():
                hpos.update(h.lemma_names())
        return syns, hyps, hpos

    per_label = {lbl: get_syn_hyper(lbl) for lbl in label2ans}
    out: dict[int, dict] = {}
    for i, lbl in enumerate(label2ans):
        syns, hyps, hpos = per_label[lbl]
        rel = {"syn": [], "hyp": [], "hpo": []}
        for j, other in enumerate(label2ans):
            if j == i:
                continue
            if other in syns:
                rel["syn"].append(j)
            elif other in hyps:
                rel["hyp"].append(j)
            elif other in hpos:
                rel["hpo"].append(j)
        out[i] = rel
    return out


def phrase_vector(phrase: str, vectors: dict[str, np.ndarray],
                  dim: int) -> np.ndarray:
    """Mean of token vectors (spaCy doc.vector semantics); zeros for OOV."""
    toks = [vectors[t] for t in phrase.split() if t in vectors]
    if not toks:
        return np.zeros((dim,), np.float32)
    return np.mean(toks, axis=0)


def build_embedding_distances(label2ans: list[str],
                              vectors: dict[str, np.ndarray]) -> dict:
    """-> {(i, j): 1 - cos_sim} symmetric dict (embedding_distance.pkl
    format)."""
    dim = len(next(iter(vectors.values())))
    V = np.stack([phrase_vector(l, vectors, dim) for l in label2ans])
    norms = np.linalg.norm(V, axis=1)
    safe = np.where(norms > 0, norms, 1.0)
    Vn = V / safe[:, None]
    sim = Vn @ Vn.T
    out = {}
    n = len(label2ans)
    for i in range(n):
        for j in range(i + 1, n):
            d = float(1.0 - sim[i, j])
            out[(i, j)] = d
            out[(j, i)] = d
    return out


def load_glove_vectors(path: str, *, vocab: set[str] | None = None
                       ) -> dict[str, np.ndarray]:
    vectors: dict[str, np.ndarray] = {}
    dim = None
    with open(path, encoding="utf8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            if dim is None:
                dim = len(parts) - 1
            # split from the RIGHT: standard GloVe releases contain
            # entries whose "word" itself has spaces (glove.840B has
            # '. . .', 'name@domain.com …'); left-splitting feeds text
            # into the float parse
            word = " ".join(parts[:-dim])
            if vocab is not None and word not in vocab:
                continue
            try:
                vectors[word] = np.asarray(parts[-dim:], np.float32)
            except ValueError:
                continue        # malformed line — skip, don't abort
    return vectors


def save_pickle(obj, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)
