"""Maximal Marginal Relevance frame selection (copy of
univid_tpu/reflection/mmr.py; reference mmr_select,
eval_understanding.py:225-240):
greedy argmax of lam*sim(query) - (1-lam)*max-sim(selected). Host-side
numpy — N is at most the 64-frame pool.
"""

from __future__ import annotations

from typing import List

import numpy as np


def mmr_select(embs: np.ndarray, query_emb: np.ndarray, k: int,
               lam: float = 0.5) -> List[int]:
    embs = np.asarray(embs, np.float64)
    q = np.asarray(query_emb, np.float64).reshape(-1)
    sims_q = embs @ q
    sims_ii = embs @ embs.T
    n = embs.shape[0]
    selected: List[int] = []
    candidates = set(range(n))
    while len(selected) < min(k, n) and candidates:
        best_i, best_score = None, -1e9
        for i in candidates:
            div = 0.0 if not selected else float(
                np.max(sims_ii[i, selected]))
            score = lam * float(sims_q[i]) - (1.0 - lam) * div
            if score > best_score:
                best_score, best_i = score, i
        selected.append(best_i)
        candidates.remove(best_i)
    return selected
