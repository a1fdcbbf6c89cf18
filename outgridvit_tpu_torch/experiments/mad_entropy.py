"""Mean-Attention-Distance (MAD) and attention-entropy metrics: the port's
own copy of ``outgridvit_tpu/experiments/mad_entropy.py`` (numpy; the same
samplers, seed-mixing constants and row schema). The public functions take
the port's model, which holds its weights, in place of JAX's ``(model,
variables)``.

Numpy reimplementation of the reference's quantitative attention analysis
(`src/experiments/mad_metrics.py`, `src/experiments/entropy_metrics.py`) with
the same sampling scheme (border-excluding query/position samplers with the
same seed-mixing constants) and the same output row schema, operating on
tensors captured via :mod:`outgridvit_tpu_torch.experiments.capture`.

Definitions:
- Grid MAD: attention-weighted L1 pixel distance between query and keys in
  FULL feature-map coordinates (keys of grid group (gy,gx) live at
  (i*g+gy, j*g+gx)), averaged over sampled queries x all g^2 groups x images.
- Outlooker MAD: kernel-weighted L1 over the 3x3 tap grid
  (distance matrix [[2,1,2],[1,0,1],[2,1,2]]), normalized by /2.
- Entropy: Shannon entropy (nats) of attention rows / kernels, normalized by
  log(N) (grid) or log(9) (outlooker).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

_EPS = 1e-12


# ----------------------------------------------------------------- sampling

def sample_q_indices(Hg, Wg, n_q=32, seed=0, exclude_border=1) -> List[int]:
    ys, xs = np.arange(Hg), np.arange(Wg)
    Y, X = np.meshgrid(ys, xs, indexing="ij")
    if exclude_border > 0:
        mask = (
            (Y >= exclude_border) & (Y < Hg - exclude_border)
            & (X >= exclude_border) & (X < Wg - exclude_border)
        )
        valid = np.nonzero(mask.reshape(-1))[0]
    else:
        valid = np.arange(Hg * Wg)
    rng = np.random.default_rng(seed)
    if len(valid) <= n_q:
        return valid.tolist()
    idx = rng.choice(len(valid), size=n_q, replace=False)
    return valid[idx].tolist()


def sample_xy(H, W, n_xy=64, seed=0, exclude_border=1) -> List[Tuple[int, int]]:
    rng = np.random.default_rng(seed)
    ys = np.arange(exclude_border, H - exclude_border)
    xs = np.arange(exclude_border, W - exclude_border)
    if len(ys) == 0 or len(xs) == 0:
        return []
    Y, X = np.meshgrid(ys, xs, indexing="ij")
    coords = np.stack([Y.reshape(-1), X.reshape(-1)], axis=1)
    if len(coords) <= n_xy:
        return [tuple(c) for c in coords]
    idx = rng.choice(len(coords), size=n_xy, replace=False)
    return [tuple(c) for c in coords[idx]]


# ----------------------------------------------------------------- grid MAD

def _entropy(p: np.ndarray) -> float:
    p = np.clip(p, _EPS, None)
    p = p / p.sum()
    return float(-(p * np.log(p)).sum())


def grid_attn_mad_entropy_for_query(
    attn, Hg, Wg, g, b, gy, gx, q_idx, head_reduce="mean"
):
    """attn: [Bgrp, heads, N, N]. Returns (mad_abs, H, Hn)."""
    N = Hg * Wg
    grp = b * (g * g) + gy * g + gx
    A = attn[grp]
    if head_reduce == "mean":
        A = A.mean(0)
    elif head_reduce == "max":
        A = A.max(0)
    else:
        raise ValueError("head_reduce must be 'mean' or 'max'")
    w = A[q_idx]
    w = w / (w.sum() + _EPS)

    qy, qx = q_idx // Wg, q_idx % Wg
    ky = np.repeat(np.arange(Hg), Wg)
    kx = np.tile(np.arange(Wg), Hg)
    # full-featuremap coords by interleaving
    dist = np.abs((ky - qy) * g) + np.abs((kx - qx) * g)
    mad = float((w * dist).sum())
    H = _entropy(w)
    Hn = H / np.log(N) if N > 1 else 0.0
    return mad, H, float(Hn)


def outlooker_kernel_mad_norm(k3x3: np.ndarray) -> float:
    k = np.clip(k3x3, 0.0, None)
    k = k / (k.sum() + _EPS)
    dist = np.array([[2, 1, 2], [1, 0, 1], [2, 1, 2]], dtype=k.dtype)
    return float((k * dist).sum() / 2.0)


def outlooker_kernel_entropy(k3x3: np.ndarray):
    H = _entropy(k3x3.reshape(-1))
    return H, float(H / np.log(9.0))


def _outlook_weights(logits: np.ndarray) -> np.ndarray:
    """[B, Hs, Ws, heads, kk] pre-softmax -> softmaxed over kk."""
    z = logits - logits.max(-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(-1, keepdims=True)


def outlooker_mad_entropy_for_image_sampled(
    logits_b: np.ndarray, n_xy=64, seed=0, exclude_border=1
):
    """logits_b: [1, Hs, Ws, heads, 9]. Returns dict of MAD/H stats or None."""
    w = _outlook_weights(logits_b)[0]  # [Hs, Ws, heads, 9]
    H_, W_ = w.shape[0], w.shape[1]
    eb = int(exclude_border)
    if H_ - 2 * eb <= 0 or W_ - 2 * eb <= 0:
        eb = 0
    coords = sample_xy(H_, W_, n_xy=n_xy, seed=seed, exclude_border=eb)
    if not coords:
        coords = sample_xy(H_, W_, n_xy=n_xy, seed=seed, exclude_border=0)
        if not coords:
            return None
    mads, Hs, Hns = [], [], []
    for (y, x) in coords:
        k = w[y, x].mean(0).reshape(3, 3)  # head-mean kernel
        mads.append(outlooker_kernel_mad_norm(k))
        H, Hn = outlooker_kernel_entropy(k)
        Hs.append(H)
        Hns.append(Hn)
    return {
        "mad_mean": float(np.mean(mads)),
        "mad_std": float(np.std(mads)),
        "H_mean": float(np.mean(Hs)),
        "H_std": float(np.std(Hs)),
        "Hn_mean": float(np.mean(Hns)),
        "Hn_std": float(np.std(Hns)),
    }


# --------------------------------------------------------------- stage sweep

def _stage_rows(
    captures: Dict,
    stages,
    block_idx: int,
    n_images: int,
    seed: int,
    normalize_grid: bool,
    grid_n_q: int,
    grid_exclude_border: int,
    grid_avg_over_groups: bool,
    out_n_xy: int,
    out_exclude_border: int,
    with_entropy: bool,
):
    results = []
    for s in stages:
        pack = captures.get((s, block_idx))
        grid_ok = pack is not None and pack.get("grid_attn") is not None
        out_ok = pack is not None and pack.get("outlook_logits") is not None

        row = {
            "stage": s, "block": block_idx, "seed": seed,
            "n_images": int(n_images),
            "grid_n_q": grid_n_q, "grid_exclude_border": grid_exclude_border,
            "grid_avg_over_groups": bool(grid_avg_over_groups),
            "out_n_xy": out_n_xy, "out_exclude_border": out_exclude_border,
            "MAD_grid_mean": None, "MAD_grid_std": None,
            "grid_Hf": None, "grid_Wf": None, "grid_denom": None,
            "MAD_grid_abs_mean": None,
            "MAD_outlook_mean": None, "MAD_outlook_std": None,
            "MAD_outlook_abs_mean": None,
        }
        if with_entropy:
            row.update({
                "H_grid_mean": None, "Hn_grid_mean": None, "Hn_grid_std": None,
                "H_outlook_mean": None, "Hn_outlook_mean": None,
                "Hn_outlook_std": None,
            })

        if grid_ok:
            attn = pack["grid_attn"]
            Hg, Wg = pack["grid_hw"]
            g = pack["g"]
            n = pack["meta"][0]
            Hf, Wf = Hg * g, Wg * g
            denom = float((Hf - 1) + (Wf - 1)) if normalize_grid else 1.0
            per_image, per_H, per_Hn = [], [], []
            gy_range = range(g) if grid_avg_over_groups else [0]
            gx_range = range(g) if grid_avg_over_groups else [0]
            for b in range(n):
                vals, hs, hns = [], [], []
                for gy in gy_range:
                    for gx in gx_range:
                        q_seed = (seed + 100000 * (s if isinstance(s, int) else 0)
                                  + 1000 * b + 97 * gy + 131 * gx
                                  + 17 * block_idx)
                        q_idxs = sample_q_indices(
                            Hg, Wg, n_q=grid_n_q, seed=q_seed,
                            exclude_border=grid_exclude_border)
                        if not q_idxs:
                            # adaptive fallback for tiny token grids (the
                            # reference does this for the outlooker path,
                            # `mad_metrics.py:166-174`)
                            q_idxs = sample_q_indices(
                                Hg, Wg, n_q=grid_n_q, seed=q_seed,
                                exclude_border=0)
                        if not q_idxs:
                            continue
                        trio = [grid_attn_mad_entropy_for_query(
                            attn, Hg, Wg, g, b, gy, gx, q) for q in q_idxs]
                        vals.append(np.mean([t[0] for t in trio]) / denom
                                    if normalize_grid
                                    else np.mean([t[0] for t in trio]))
                        hs.append(np.mean([t[1] for t in trio]))
                        hns.append(np.mean([t[2] for t in trio]))
                if vals:
                    per_image.append(float(np.mean(vals)))
                    per_H.append(float(np.mean(hs)))
                    per_Hn.append(float(np.mean(hns)))
            if per_image:
                row["MAD_grid_mean"] = float(np.mean(per_image))
                row["MAD_grid_std"] = float(np.std(per_image))
                row["grid_Hf"], row["grid_Wf"] = Hf, Wf
                row["grid_denom"] = denom
                row["MAD_grid_abs_mean"] = (
                    row["MAD_grid_mean"] * denom if normalize_grid
                    else row["MAD_grid_mean"])
                if with_entropy:
                    row["H_grid_mean"] = float(np.mean(per_H))
                    row["Hn_grid_mean"] = float(np.mean(per_Hn))
                    row["Hn_grid_std"] = float(np.std(per_Hn))

        if out_ok:
            logits = pack["outlook_logits"]
            n = logits.shape[0]
            mus, hmeans, hns, hnstds = [], [], [], []
            for b in range(n):
                o_seed = (seed + 200000 * (s if isinstance(s, int) else 0)
                          + 1000 * b + 19 * block_idx)
                st = outlooker_mad_entropy_for_image_sampled(
                    logits[b : b + 1], n_xy=out_n_xy, seed=o_seed,
                    exclude_border=out_exclude_border)
                if st is not None:
                    mus.append(st["mad_mean"])
                    hmeans.append(st["H_mean"])
                    hns.append(st["Hn_mean"])
            if mus:
                row["MAD_outlook_mean"] = float(np.mean(mus))
                row["MAD_outlook_std"] = float(np.std(mus))
                row["MAD_outlook_abs_mean"] = row["MAD_outlook_mean"] * 2.0
                if with_entropy:
                    row["H_outlook_mean"] = float(np.mean(hmeans))
                    row["Hn_outlook_mean"] = float(np.mean(hns))
                    row["Hn_outlook_std"] = float(np.std(hns))

        if not grid_ok and not out_ok:
            print(f"[WARN] No captures (grid/outlooker) in stage={s}, "
                  f"block={block_idx}")
            continue
        results.append(row)
    return results


def _captures_for(model, loader, n_images, seed):
    """Pick one batch and ``n_images`` of its images on the host with the
    JAX sampler's draws, then capture on the model's device."""
    from outgridvit_tpu_torch.experiments.capture import capture_attention

    rng = np.random.default_rng(seed)
    it = iter(loader)
    nb = len(loader) if hasattr(loader, "__len__") else 1
    j = int(rng.integers(0, nb))
    for _ in range(j):
        next(it)
    x, _ = next(it)
    B = x.shape[0]
    idxs = rng.choice(B, size=min(n_images, B), replace=False)
    x = np.asarray(x)[idxs]
    return capture_attention(model, x)


def compute_grid_and_outlooker_mad_by_stage(
    model, loader,
    block_idx=0, stages=(0, 1, 2, 3), n_images=64, seed=10,
    normalize_grid=True, grid_n_q=32, grid_exclude_border=1,
    grid_avg_over_groups=True, out_n_xy=64, out_exclude_border=1,
):
    """Reference `mad_metrics.py:186-337` with identical row schema."""
    captures = _captures_for(model, loader, n_images, seed)
    return _stage_rows(
        captures, stages, block_idx, n_images, seed, normalize_grid,
        grid_n_q, grid_exclude_border, grid_avg_over_groups,
        out_n_xy, out_exclude_border, with_entropy=False,
    )


def compute_grid_and_outlooker_mad_entropy_by_stage(
    model, loader,
    block_idx=0, stages=(0, 1, 2, 3), n_images=64, seed=10,
    normalize_grid=True, grid_n_q=32, grid_exclude_border=1,
    grid_avg_over_groups=True, out_n_xy=64, out_exclude_border=1,
):
    """Reference `entropy_metrics.py:214-407`: MAD + entropy rows."""
    captures = _captures_for(model, loader, n_images, seed)
    return _stage_rows(
        captures, stages, block_idx, n_images, seed, normalize_grid,
        grid_n_q, grid_exclude_border, grid_avg_over_groups,
        out_n_xy, out_exclude_border, with_entropy=True,
    )


def run_mad_entropy_pipeline(
    model, loader, seeds=(10, 20, 30), stages=(0, 1, 2, 3),
    blocks=(0,), **kw,
):
    """Sweep seeds x blocks (reference `entropy_metrics.py:410-439`)."""
    all_rows = []
    for seed in seeds:
        for b in blocks:
            all_rows.extend(
                compute_grid_and_outlooker_mad_entropy_by_stage(
                    model, loader, block_idx=b, stages=stages,
                    seed=seed, **kw,
                )
            )
    return all_rows


def _vals(rs, key):
    return [r[key] for r in rs if r.get(key) is not None]


def print_mad_abs_by_stage_simple(all_res):
    """Reference `mad_metrics.py:349-378` abs-scale summary printer."""
    by_stage = {}
    for r in all_res:
        by_stage.setdefault(r["stage"], []).append(r)
    print("\n=== MAD (ABS) by stage — simple view ===")
    print("GRID_abs is in featuremap L1 pixels; max = (Hf-1)+(Wf-1).")
    print("OUT_abs  is in 3x3 L1 steps; max = 2.\n")
    for s in sorted(by_stage, key=str):
        rs = by_stage[s]
        g = _vals(rs, "MAD_grid_abs_mean")
        o = _vals(rs, "MAD_outlook_abs_mean")

        def f2(vals):
            if not vals:
                return "None"
            return f"{np.mean(vals):.2f}±{np.std(vals):.2f} (n={len(vals)})"

        denoms = sorted(set(_vals(rs, "grid_denom")))
        scale = (f"GRID max={denoms[0]:.0f}" if denoms else "GRID max=?") + " | OUT max=2"
        print(f"stage {s}:  GRID_abs={f2(g)}   |   OUT_abs={f2(o)}   |   {scale}")
