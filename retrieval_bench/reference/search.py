"""Exact top-k search by its definition: the raw queries whitened in
float64, ``L2N((q - m) @ P.T)`` (eps 1e-6 on the norm), rounded to float32
and then to the gallery's storage dtype, scored in float64 against every
gallery row, ranked by (score desc, index asc)."""

from typing import Tuple

import numpy as np
import torch

GALLERY_BLOCK = 65536


def whiten(q: np.ndarray, m: np.ndarray, P: np.ndarray, storage: torch.dtype,
           device) -> torch.Tensor:
    """[n, D'] float64 whitened queries, as the storage dtype holds them."""
    x = (np.asarray(q, np.float64) - np.asarray(m, np.float64)) @ np.asarray(P, np.float64).T
    x = x / (np.sqrt((x * x).sum(axis=1, keepdims=True)) + 1e-6)
    return torch.as_tensor(x.astype(np.float32), device=device).to(storage).double()


@torch.no_grad()
def top_k(qw: torch.Tensor, gallery: torch.Tensor, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """(scores [n, k] float64, ids [n, k]) of the exact top-k, ties to the
    lower index."""
    k = min(k, gallery.shape[0])
    keep = min(k + 16, gallery.shape[0])
    cand_s, cand_i = [], []
    for s in range(0, gallery.shape[0], GALLERY_BLOCK):
        sc = qw @ gallery[s : s + GALLERY_BLOCK].double().T
        v, i = torch.topk(sc, min(keep, sc.shape[1]), dim=1)
        cand_s.append(v.cpu().numpy())
        cand_i.append(i.cpu().numpy() + s)
    cs, ci = np.concatenate(cand_s, axis=1), np.concatenate(cand_i, axis=1)
    out_s = np.empty((cs.shape[0], k))
    out_i = np.empty((cs.shape[0], k), np.int64)
    for r in range(cs.shape[0]):
        order = np.lexsort((ci[r], -cs[r]))[:k]
        out_s[r], out_i[r] = cs[r, order], ci[r, order]
    return out_s, out_i


@torch.no_grad()
def scores_of(qw: torch.Tensor, gallery: torch.Tensor, ids: np.ndarray) -> np.ndarray:
    """[n, k] float64 scores of the given gallery rows (ids out of range
    score -inf)."""
    ids = np.asarray(ids, np.int64)
    ok = (ids >= 0) & (ids < gallery.shape[0])
    rows = torch.as_tensor(np.where(ok, ids, 0), device=gallery.device)
    g = gallery[rows.reshape(-1)].double().reshape(ids.shape[0], ids.shape[1], -1)
    s = torch.einsum("nkd,nd->nk", g, qw).cpu().numpy()
    return np.where(ok, s, -np.inf)


def compare(prog_scores: np.ndarray, prog_ids: np.ndarray, ref_scores: np.ndarray,
            prog_ref: np.ndarray, ng: int) -> dict:
    """The search cells' numbers. ``rank_gap``: how far the reference's
    score of the program's j-th answer lies below the reference's j-th best
    score (an id out of range, or repeated within a query, lies infinitely
    far); ``score_err``: how far the program's score of an answer lies from
    the reference's."""
    prog_ids = np.asarray(prog_ids, np.int64)
    if prog_ids.shape != ref_scores.shape:
        return {"rank_gap": float("inf"), "score_err": float("inf")}
    prog_ref = np.array(prog_ref, np.float64)
    prog_ref[(prog_ids < 0) | (prog_ids >= ng)] = -np.inf
    order = np.argsort(prog_ids, axis=1, kind="stable")
    srt = np.take_along_axis(prog_ids, order, axis=1)
    rep = np.zeros_like(prog_ids, bool)
    np.put_along_axis(rep, order[:, 1:], srt[:, 1:] == srt[:, :-1], axis=1)
    prog_ref[rep] = -np.inf
    gap = ref_scores - prog_ref
    err = np.abs(np.asarray(prog_scores, np.float64) - prog_ref)
    gap[~np.isfinite(gap)] = np.inf
    err[~np.isfinite(err)] = np.inf
    return {"rank_gap": float(gap.max()), "score_err": float(err.max())}
