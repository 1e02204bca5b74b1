"""Fit the per-block cache classifiers from traces of the port's own
denoiser (counterpart of sduss_tpu/cache/train.py).

1. ``TraceCache`` instruments the gated denoiser: every step records, per
   gated block and row, the input drift (relative MSE against the previous
   step's input) and the true output drift (how far reusing the previous
   step's output would have been off).
2. ``collect_traces`` runs a short trajectory with it and gathers the
   ``(rel_in, t_norm, rel_out)`` rows per block.
3. ``fit_classifiers`` fits one logistic per block (numpy gradient
   descent) and saves them to one npz, which ``CacheConfig.classifier_path``
   loads: ``key -> (w_mse, w_t, w_hits, bias)``.

    python -m sduss_tpu_torch.cache.train --family sdxl --steps 20 \\
        --resolutions 512 768 1024 --out cache_classifiers.npz
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sduss_tpu_torch.cache.manager import BlockCache


def _rel(a, ref) -> torch.Tensor:
    """Per-row relative MSE of ``a`` against ``ref``, float32."""
    axes = tuple(range(1, a.dim()))
    af = a.float()
    return ((af - ref.float()).square().mean(dim=axes)
            / (af.square().mean(dim=axes) + 1e-8))


class TraceCache(BlockCache):
    """A cache that recomputes every row and records the decision features
    of each gated block: UNet patch rows ``(P, C, s, s)``, dense rows and
    MMDiT token rows ``(B, S, D)`` alike (the features reduce over every
    axis but the first, as the gates' scores do)."""

    @staticmethod
    def _add_trace_rows(rows: dict) -> dict:
        n, dev = rows["hits"].shape[0], rows["hits"].device
        for k in ("rel_in", "rel_out", "t"):
            rows[k] = torch.zeros((n,), dtype=torch.float32, device=dev)
        return rows

    def init_rows(self, key, n_rows, s, c_in, c_out, dtype=torch.bfloat16,
                  device=None) -> dict:
        return self._add_trace_rows(super().init_rows(
            key, n_rows, s, c_in, c_out, dtype, device))

    def init_token_rows(self, key, n_rows, seq, dim, dtype=torch.bfloat16,
                        device=None, ctx_seq=None) -> dict:
        return self._add_trace_rows(super().init_token_rows(
            key, n_rows, seq, dim, dtype, device))

    def gate(self, key, x, t_norm, state_k, compute_fn, reducer=None):
        """Compute every row and replace the state's entries: the fresh
        input and output, hits 0, and the features against the previous
        step's rows.  The trace runs on one device (``reducer`` None)."""
        if reducer is not None:
            raise ValueError("the classifier trace runs on one device")
        y = compute_fn(x)
        if state_k is None:
            return y, None, None
        state_k["rel_in"] = _rel(x, state_k["inp"])
        state_k["rel_out"] = _rel(y, state_k["out"])
        state_k["t"] = (t_norm.float() if t_norm is not None
                        else torch.zeros_like(state_k["rel_in"]))
        state_k["inp"], state_k["out"] = x, y
        state_k["hits"] = torch.zeros_like(state_k["hits"])
        return y, state_k, None


def collect_traces(pipeline, requests, steps: Optional[int] = None
                   ) -> Dict[str, List[Tuple[float, float, float]]]:
    """Drive ``denoise_step_mixed`` with a ``TraceCache`` in mode "block"
    and return per-block rows of ``(rel_in, t_norm, rel_out)`` from every
    step after the first (which has no previous rows).  The trace is put
    on the pipeline's one cache seam, ``_cache_obj``, which the UNet
    families' patch path (``_block_cache``) and SD3's token path
    (``_sd3_cache``) both read; the UNet rows live on the requests, SD3's
    in its composition store."""
    from sduss_tpu_torch.request import Stage

    pipeline.prepare(requests)
    for r in requests:
        r.stage = Stage.DENOISING
    cfg = pipeline.config.cache
    pipeline._cache_obj = TraceCache(cfg)
    cfg.enabled = True
    cfg.mode = "block"  # trace through the masked gate

    dataset: Dict[str, List[Tuple[float, float, float]]] = {}
    n_steps = steps or min(r.remain_steps for r in requests)
    for step_i in range(n_steps):
        by_res: Dict[int, list] = {}
        for r in requests:
            by_res.setdefault(r.resolution, []).append(r)
        pipeline.denoise_step_mixed(by_res)
        if step_i == 0:
            continue
        entries = [(key, e) for r in requests
                   for key, e in (r.cache_rows or {}).items()]
        entries += [(key, e) for st in getattr(pipeline, "_sd3_state",
                                               {}).values()
                    for key, e in (st["state"] or {}).items()]
        for key, e in entries:
            if "rel_in" not in e:
                continue
            cols = [e[k].float().cpu().numpy() for k in ("rel_in", "t",
                                                          "rel_out")]
            rows = dataset.setdefault(key, [])
            rows.extend((float(a), float(t), float(b))
                        for a, t, b in zip(*cols))
    return dataset


def fit_logistic(x: np.ndarray, y: np.ndarray, iters: int = 500,
                 lr: float = 0.5) -> np.ndarray:
    """Fit ``sigmoid(w . x + b) ~ y`` by gradient descent on standardised
    features; returns ``(w..., b)`` in the original units."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    mu, sd = x.mean(axis=0), x.std(axis=0) + 1e-9
    xs = (x - mu) / sd
    w = np.zeros(x.shape[1])
    b = 0.0
    n = len(y)
    for _ in range(iters):
        z = xs @ w + b
        p = 1.0 / (1.0 + np.exp(-np.clip(z, -30, 30)))
        g = p - y
        w -= lr * (xs.T @ g) / n
        b -= lr * float(g.mean())
    w_orig = w / sd
    b_orig = b - float(w_orig @ mu)
    return np.concatenate([w_orig, [b_orig]])


def fit_classifiers(dataset: Dict[str, List[Tuple[float, float, float]]],
                    reuse_threshold: float = 0.01,
                    out_path: Optional[str] = None) -> Dict[str, np.ndarray]:
    """Per block: label a row fresh when its true output drift is at least
    ``reuse_threshold`` and fit ``(w_mse, w_t, 0, bias)``; a block whose
    rows all carry one label gets a bias-only classifier (+-1e3)."""
    out: Dict[str, np.ndarray] = {}
    for key, rows in dataset.items():
        arr = np.asarray(rows, np.float64)
        x = arr[:, :2]  # (rel_in, t_norm)
        y = (arr[:, 2] >= reuse_threshold).astype(np.float64)
        if y.min() == y.max():
            w = np.asarray([0.0, 0.0, 0.0, 1e3 if y[0] else -1e3])
        else:
            fitted = fit_logistic(x, y)  # (w_mse, w_t, b)
            w = np.asarray([fitted[0], fitted[1], 0.0, fitted[2]])
        out[key] = w
    if out_path:
        np.savez(out_path, **out)
    return out


def main(argv=None) -> Dict[str, np.ndarray]:
    """Collect traces on the device and fit the per-block classifiers, one
    resolution per collection pass (the per-block features do not depend
    on the batch's composition, and one request's rows are the least
    memory a pass can hold)."""
    from sduss_tpu_torch.config import Config, ModelConfig
    from sduss_tpu_torch.pipelines import build_pipeline
    from sduss_tpu_torch.request import Request, SamplingParams

    ap = argparse.ArgumentParser("sduss_tpu_torch cache classifier training")
    ap.add_argument("--family", default="sdxl")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--resolutions", type=int, nargs="+", default=None)
    ap.add_argument("--reuse-threshold", type=float, default=0.01)
    ap.add_argument("--out", default="cache_classifiers.npz")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu must be asked for)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device found; pass --device cpu to run on "
                         "the CPU")
    config = Config()
    config.model = ModelConfig(model=args.family, test_tiny=args.tiny,
                               dtype=args.dtype)
    config.cache.enabled = True
    pipe = build_pipeline(config, device)
    data: Dict[str, List[Tuple[float, float, float]]] = {}
    for i, res in enumerate(args.resolutions or config.model.resolutions):
        reqs = [Request(f"train-{i}", SamplingParams(
            prompt=f"training prompt {i}", resolution=res,
            num_inference_steps=args.steps, seed=i))]
        part = collect_traces(pipe, reqs, steps=args.steps)
        for k, rows in part.items():
            data.setdefault(k, []).extend(rows)
        print(f"res {res}: {sum(len(v) for v in part.values())} trace rows")
    out = fit_classifiers(data, args.reuse_threshold, args.out)
    print(f"fitted {len(out)} block classifiers -> {args.out}")
    return out


if __name__ == "__main__":
    main()
