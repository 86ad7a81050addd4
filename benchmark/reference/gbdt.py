"""Learned ANI debias — tensorized GBDT readout.

The reference embeds two gbdt-rs LAD ensembles (195 trees, depth 3)
(reference: src/model.rs, applied in src/regression.rs:30-64).  Here the
trees are flattened to (n_trees, n_nodes) tensors (models/gbdt_*.npz,
produced by tools/convert_gbdt.py) and evaluated with a vectorized
gather/where traversal: prediction = bias + shrinkage * sum(tree leaf preds),
in f32 like the reference (gbdt-rs ValueType = f32; split rule
feature < threshold -> left).

A frozen copy of skani_tpu_torch/gbdt.py (the c 125 model only, its .npz beside this file), kept in the benchmark's reference so that no
change to the program moves it.
"""
from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np

from .params import TOTAL_BASES_REGRESS_CUTOFF

_MODEL_DIR = os.path.dirname(os.path.abspath(__file__))


class GbdtModel:
    def __init__(self, npz):
        """`npz`: a path to a model .npz, or a mapping of its arrays."""
        d = np.load(npz) if isinstance(npz, (str, os.PathLike)) else npz
        self.feature_index = d["feature_index"]
        self.threshold = d["threshold"]
        self.left = d["left"]
        self.right = d["right"]
        self.is_leaf = d["is_leaf"]
        self.pred = d["pred"]
        self.bias = np.float32(d["bias"])
        self.shrinkage = np.float32(d["shrinkage"])
        self.n_trees = int(d["n_trees"])
        self.max_depth = int(d["max_depth"])

    def predict(self, features: np.ndarray) -> np.ndarray:
        """features: (batch, 5) f32 -> (batch,) f32 predictions."""
        features = np.asarray(features, dtype=np.float32)
        if features.ndim == 1:
            features = features[None, :]
        batch = features.shape[0]
        n_nodes = self.threshold.shape[1]
        # flat-offset gathers (ndarray.take) instead of fancy double
        # indexing — same elements, ~3x less indexing overhead
        toff = (np.arange(self.n_trees, dtype=np.int32)
                * n_nodes)[None, :]
        foff = (np.arange(batch, dtype=np.int32)
                * features.shape[1])[:, None]
        fi_f = self.feature_index.ravel()
        th_f = self.threshold.ravel()
        leaf_f = self.is_leaf.ravel()
        left_f = self.left.ravel()
        right_f = self.right.ravel()
        feat_f = features.ravel()
        node = np.zeros((batch, self.n_trees), dtype=np.int32)
        for _ in range(self.max_depth + 1):
            flat = node + toff
            fi = fi_f.take(flat)
            th = th_f.take(flat)
            leaf = leaf_f.take(flat)
            fv = feat_f.take(foff + fi)
            go_left = fv < th
            nxt = np.where(go_left, left_f.take(flat), right_f.take(flat))
            node = np.where(leaf, node, nxt.astype(np.int32))
        leaf_pred = self.pred.ravel().take(node + toff)
        # f32 accumulation order: bias + shrinkage*p0 + shrinkage*p1 + ...
        # ufunc.accumulate is sequential by definition, so one accumulate
        # reproduces the per-tree loop's rounding bit-for-bit
        contrib = np.concatenate(
            [np.full((batch, 1), self.bias, dtype=np.float32),
             (self.shrinkage * leaf_pred).astype(np.float32)], axis=1)
        return np.add.accumulate(contrib, axis=1,
                                 dtype=np.float32)[:, -1]


@functools.lru_cache(maxsize=2)
def _load(name: str) -> GbdtModel:
    return GbdtModel(os.path.join(_MODEL_DIR, name))


def get_model(c: int, learned_ani: bool) -> Optional[GbdtModel]:
    """reference: src/regression.rs:12-28"""
    if not learned_ani:
        return None
    if abs(c - 125) < abs(c - 200):
        return _load("gbdt_c125.npz")
    raise ValueError("the benchmark's reference holds the c 125 model only")


def _gbdt_features(ani_res) -> list:
    """reference: src/regression.rs:33-55 — feature order depends on which
    genome has the larger median contig length."""
    if ani_res.quant_50_contig_len_r > ani_res.quant_50_contig_len_q:
        return [np.float32(ani_res.ani) * np.float32(100.0),
                ani_res.std,
                ani_res.quant_90_contig_len_r,
                ani_res.quant_90_contig_len_q,
                np.float32(ani_res.avg_chain_int_len)]
    return [np.float32(ani_res.ani) * np.float32(100.0),
            ani_res.std,
            ani_res.quant_90_contig_len_q,
            ani_res.quant_90_contig_len_r,
            np.float32(ani_res.avg_chain_int_len)]


def _gbdt_qualifies(ani_res) -> bool:
    """reference: src/regression.rs:31"""
    return bool(np.float32(ani_res.ani) > np.float32(0.9)
                and ani_res.total_bases_covered > TOTAL_BASES_REGRESS_CUTOFF)


def _gbdt_apply(ani_res, pred: float) -> None:
    """reference: src/regression.rs:58-62"""
    if pred < 100.0:
        p = float(np.float32(pred) / np.float32(100.0))
        ani_res.ci_upper = float(np.float32(ani_res.ci_upper)
                                 - np.float32(ani_res.ani) + np.float32(p))
        ani_res.ci_lower = float(np.float32(ani_res.ci_lower)
                                 - np.float32(ani_res.ani) + np.float32(p))
        ani_res.ani = p


def predict_from_ani_res(ani_res, model: GbdtModel) -> None:
    """reference: src/regression.rs:30-64"""
    if not _gbdt_qualifies(ani_res):
        return
    feats = _gbdt_features(ani_res)
    pred = float(model.predict(np.array(feats, dtype=np.float32))[0])
    _gbdt_apply(ani_res, pred)
