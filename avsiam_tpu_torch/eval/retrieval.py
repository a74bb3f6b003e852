"""Audio<->visual retrieval evaluation.

The port's own copy of ``avsiam_tpu/eval/retrieval.py`` (numpy only; the
port imports nothing of that package). Parity: src/retrieval.py —
mean-pool per-modality token embeddings, L2-normalize, cosine similarity
matrix, R@1/R@5/R@10/MedianR in both directions. The reference's O(B^2)
Python cosine loop (retrieval.py:32-38) becomes one normalized [B, D] x
[D, B] product.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def compute_metrics(sim: np.ndarray) -> Dict[str, float]:
    """Rank-based retrieval metrics from a similarity matrix.

    Parity: src/retrieval.py:40-52 — rank of the diagonal entry within each
    row of the descending-sorted similarities. Ties: every position in the
    sorted row that holds the diagonal's value counts (``np.where`` over
    the whole row), as the reference does.
    """
    sx = np.sort(-sim, axis=1)
    d = np.diag(-sim)[:, np.newaxis]
    ind = np.where(sx - d == 0)[1]
    return {
        "R1": float(np.sum(ind == 0)) / len(ind),
        "R5": float(np.sum(ind < 5)) / len(ind),
        "R10": float(np.sum(ind < 10)) / len(ind),
        "MR": float(np.median(ind)) + 1,
    }


def similarity_matrix(a_feat: np.ndarray, b_feat: np.ndarray) -> np.ndarray:
    """Cosine similarity [B, B] from raw [B, D] features."""
    a = a_feat / np.maximum(np.linalg.norm(a_feat, axis=-1, keepdims=True),
                            1e-12)
    b = b_feat / np.maximum(np.linalg.norm(b_feat, axis=-1, keepdims=True),
                            1e-12)
    return a @ b.T


def retrieval_metrics(a_feat: np.ndarray, v_feat: np.ndarray,
                      direction: str = "audio") -> Dict[str, float]:
    """direction='audio': audio->visual retrieval; 'video': visual->audio.
    Parity: src/retrieval.py:86-95."""
    sim = (similarity_matrix(a_feat, v_feat) if direction == "audio"
           else similarity_matrix(v_feat, a_feat))
    return compute_metrics(sim)


def pooled_features(a_tokens: np.ndarray, v_tokens: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Mean-pool token sequences to clip embeddings (retrieval.py:77-80;
    normalization happens inside similarity_matrix)."""
    return a_tokens.mean(axis=1), v_tokens.mean(axis=1)
