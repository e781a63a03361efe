"""Superpixel affinity graph + spectral normalized cut (SURVEY.md C11-C13).

Pipeline (all jit/vmap-able, SURVEY.md §3.3):

    slic labels -> scatter-mean superpixel features F (S, D)
    -> dense affinity W = exp(-||F_i - F_j||^2 / (2 sigma^2))   [matmul]
    -> L_sym = I - D^-1/2 W D^-1/2
    -> k smallest eigenvectors (jnp.linalg.eigh; S ~ 300-1000 so dense is
       cheap on-chip — the Lanczos route only pays off for much larger S)
    -> row-normalized spectral embedding -> deterministic k-means
    -> region ids gathered back to pixels.

Semantics ground truth: sklearn spectral_clustering (_spectral.py:194) with
the Ng-Jordan-Weiss row normalization; sigma defaults to the median
pairwise distance (median heuristic) when the config leaves it None.

The min-cut variant (C13) is a Felzenszwalb-style greedy merge
(segmentation.hpp:44-69 semantics) on the superpixel adjacency graph —
union-find is inherently sequential, so it runs on host over the tiny
S-node graph (SURVEY.md §7.4), not per-pixel.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gabor_color_image_segmentation.config import PipelineConfig
from gabor_color_image_segmentation.dispatch import resolve_eig_method
from gabor_color_image_segmentation.models.kmeans import kmeans
from gabor_color_image_segmentation.models.slic import slic


def superpixel_means(
    features: jnp.ndarray, labels: jnp.ndarray, n_sp: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(N, D) features + (N,) labels -> ((S, D) means, (S,) counts).

    Scatter-mean as a one-hot matmul (S, N) @ (N, D). Precision follows
    ops/precision.py: HIGHEST for genuine f32 features (a DEFAULT f32 dot
    may round its operands), DEFAULT when the feature tensor is already
    bf16 (one-hot weights are bf16-exact). In bf16 mode the one-hot is
    stored bf16 too — 0/1 are bf16-exact and both reductions accumulate in
    f32, so results equal the f32-stored one-hot's while the materialized
    (N, S) tensor halves."""
    from gabor_color_image_segmentation.ops.precision import precision_for

    prec = precision_for(features.dtype)
    oh_dtype = (
        jnp.bfloat16 if features.dtype == jnp.bfloat16 else jnp.float32
    )
    onehot = jax.nn.one_hot(labels, n_sp, dtype=oh_dtype)  # (N, S)
    sums = jnp.dot(
        onehot.T,
        features,
        preferred_element_type=jnp.float32,
        precision=prec,
    )
    cnts = jnp.sum(onehot, axis=0, dtype=jnp.float32)
    return sums / jnp.maximum(cnts, 1.0)[:, None], cnts


def affinity_matrix(
    f: jnp.ndarray,
    sigma: float | None = None,
    counts: jnp.ndarray | None = None,
    sigma_scale: float = 1.0,
) -> jnp.ndarray:
    """(S, D) -> (S, S) Gaussian affinity; sigma=None -> median heuristic,
    with ``sigma_scale`` multiplying the median bandwidth (sigma^2 =
    sigma_scale * median(d2) — GraphConfig.affinity_sigma_scale; the
    round-5 diagnosis measured the raw median ~4x too soft for boundary
    quality). Ignored when ``sigma`` is explicit.

    Empty superpixels (counts == 0) get an all-zero affinity row/col — NO
    self-loop. With the degree clamp in spectral_labels this puts each dead
    node at L_sym eigenvalue exactly 1 (identity row), OUT of the bottom-k
    eigenspace. A unit self-loop instead makes every dead node an isolated
    zero-eigenvalue vertex; fragmented images (connectivity enforcement can
    kill 150-340 of 384 superpixels on flat synthetic mosaics) then fill
    the n-cut embedding with arbitrary dead-node indicators and the cut
    collapses to one region (measured PRI 0.24 vs 0.90 healthy; the fix
    recovers it).
    """
    sq = jnp.sum(f * f, axis=1)
    d2 = (
        sq[:, None]
        - 2.0
        * jnp.dot(
            f, f.T, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        + sq
    )
    d2 = jnp.maximum(d2, 0.0)
    if sigma is None:
        s = d2.shape[0]
        # Large graphs estimate the median from a 4x4-strided subsample
        # (54k entries at S=928): the same statistic to ~1-2%, far inside
        # the flat region of the sigma_scale sweep, at 1/16 the sort.
        # Small graphs keep the exact median; golden mirrors the identical
        # stride rule.
        d2m = d2[::4, ::4] if s > 512 else d2
        med = jnp.median(d2m)
        s2 = jnp.maximum(med, 1e-12) * sigma_scale
    else:
        s2 = 2.0 * sigma * sigma
    w = jnp.exp(-d2 / s2)
    if counts is not None:
        alive = (counts > 0).astype(w.dtype)
        w = w * alive[:, None] * alive[None, :]
    return w


def smallest_eigvecs_subspace(
    l_sym: jnp.ndarray, k: int, n_iter: int = 80, oversample: int = 4,
    power_per_qr: int = 8,
) -> jnp.ndarray:
    """k eigenvectors of the smallest eigenvalues via subspace (orthogonal)
    iteration — the matmul-only eigensolver (BASELINE north_star names the
    Lanczos/matmul route for larger S where dense eigh stops paying off).

    Iterates Q <- qr((2I - L)^p Q): L_sym's spectrum lies in [0, 2], so
    2I - L flips it and power iterations converge to the SMALLEST
    eigenvalues of L. ``power_per_qr`` chains p matmuls per QR
    re-orthogonalization (QR is the sequential part of the loop); with
    ||B|| <= 2 and p = 8 the un-orthogonalized block stays f32-conditioned.
    Deterministic start (no PRNG): first k+q columns of a DCT-like cosine
    basis. Returns (S, k).
    """
    s = l_sym.shape[0]
    m = min(s, k + oversample)
    # the n-cut eigengaps are far below bf16/TF32 resolution, so every dot
    # here pins Precision.HIGHEST (S is small)
    hi = jax.lax.Precision.HIGHEST
    # deterministic, well-conditioned start: cosine basis columns
    i = jnp.arange(s, dtype=jnp.float32).reshape(-1, 1)
    j = jnp.arange(m, dtype=jnp.float32).reshape(1, -1)
    q0 = jnp.cos(jnp.pi * (i + 0.5) * j / s)
    q0, _ = jnp.linalg.qr(q0)
    b = 2.0 * jnp.eye(s, dtype=l_sym.dtype) - l_sym

    def body(_, q):
        for _ in range(power_per_qr):
            q = jnp.dot(b, q, preferred_element_type=jnp.float32,
                        precision=hi)
        q, _ = jnp.linalg.qr(q)
        return q

    q = jax.lax.fori_loop(0, max(1, n_iter // power_per_qr), body, q0)
    # Rayleigh-Ritz: diagonalize the small projected matrix for clean vectors
    t = jnp.dot(
        jnp.dot(q.T, l_sym, preferred_element_type=jnp.float32, precision=hi),
        q,
        preferred_element_type=jnp.float32,
        precision=hi,
    )  # (m, m)
    evals, v = jnp.linalg.eigh(t)
    return jnp.dot(q, v, preferred_element_type=jnp.float32, precision=hi)[:, :k]


def spectral_labels(
    w: jnp.ndarray, n_regions: int, n_iter: int = 30, eig_method: str = "auto"
) -> jnp.ndarray:
    """(S, S) affinity -> (S,) region labels via normalized-cut embedding.

    eig_method: "eigh" (dense, exact — what "auto" resolves to) or
    "subspace" (matmul-only subspace iteration); dispatch.resolve_eig_method.
    """
    eig_method = resolve_eig_method(eig_method)
    s = w.shape[0]
    deg = jnp.sum(w, axis=1)
    d_isqrt = 1.0 / jnp.sqrt(jnp.maximum(deg, 1e-12))
    l_sym = jnp.eye(s) - d_isqrt[:, None] * w * d_isqrt[None, :]
    if eig_method == "eigh":
        evals, evecs = jnp.linalg.eigh(l_sym)  # ascending
        emb = evecs[:, :n_regions]  # k smallest — the n-cut embedding
    else:
        emb = smallest_eigvecs_subspace(l_sym, n_regions)
    # Ng-Jordan-Weiss row normalization
    norm = jnp.sqrt(jnp.maximum(jnp.sum(emb * emb, axis=1, keepdims=True), 1e-12))
    emb = emb / norm
    labels, _ = kmeans(emb, n_regions, n_iter)
    return labels


def ncut_regions(
    features: jnp.ndarray,
    sp: jnp.ndarray,
    n_sp: int,
    n_regions: int,
    affinity_sigma: float | None = None,
    eig_method: str = "auto",
    sigma_scale: float = 1.0,
) -> jnp.ndarray:
    """(H,W,D) features + (H,W) superpixel labels -> (S,) region ids."""
    h, w, d = features.shape
    flat_sp = sp.reshape(-1)
    f, cnts = superpixel_means(features.reshape(-1, d), flat_sp, n_sp)
    aff = affinity_matrix(f, affinity_sigma, cnts, sigma_scale)
    return spectral_labels(aff, n_regions, eig_method=eig_method)  # (S,)


def ncut_from_superpixels(
    features: jnp.ndarray,
    sp: jnp.ndarray,
    n_sp: int,
    n_regions: int,
    affinity_sigma: float | None = None,
    eig_method: str = "auto",
    sigma_scale: float = 1.0,
) -> jnp.ndarray:
    """(H,W,D) features + (H,W) superpixel labels -> (H,W) int32 regions."""
    h, w, _ = features.shape
    regions = ncut_regions(
        features, sp, n_sp, n_regions, affinity_sigma, eig_method,
        sigma_scale,
    )
    return regions[sp.reshape(-1)].reshape(h, w).astype(jnp.int32)


def ncut_segment(
    features: jnp.ndarray,
    lab: jnp.ndarray,
    n_superpixels: int,
    n_regions: int,
    ruler: float = 10.0,
    slic_iters: int = 10,
    affinity_sigma: float | None = None,
    eig_method: str = "auto",
    sigma_scale: float = 1.0,
) -> jnp.ndarray:
    """Single image: (H,W,D) features + (H,W,3) Lab -> (H,W) int32 regions."""
    h, w, _ = features.shape
    sp = slic(lab, n_superpixels, ruler, slic_iters)  # (H, W)
    from gabor_color_image_segmentation.models.slic import (
        enforce_connectivity_device,
        grid_shape,
    )

    gh, gw, _ = grid_shape(h, w, n_superpixels)
    sp = enforce_connectivity_device(sp[None], gh * gw)[0]
    return ncut_from_superpixels(
        features, sp, gh * gw, n_regions, affinity_sigma, eig_method,
        sigma_scale,
    )


def graph_segment_batch(
    features: jnp.ndarray, lab: jnp.ndarray, cfg: PipelineConfig
) -> jnp.ndarray:
    """(B,H,W,D) features + (B,H,W,3) Lab -> (B,H,W) int32 region labels.

    SLIC and connectivity run batched; the n-cut stage vmaps over images.

    Deliberately NOT jitted: every production caller invokes it inside the
    jitted ``segment_batch``, and a nested ``jax.jit`` with static dataclass
    args trips a jax-0.9.0 dispatch bug — after another static variant of
    the OUTER function has run, the second execution of a variant fails
    with "Execution supplied 1 buffers but compiled program expected 13
    buffers". Standalone callers should wrap it in their own jit."""
    g = cfg.graph
    if g.cut == "ncut":
        from gabor_color_image_segmentation.models.slic import (
            enforce_connectivity_device,
            grid_shape,
            slic_batch,
        )

        b, h, w, _ = features.shape
        eig_method = resolve_eig_method(g.eig_method)
        sp = slic_batch(lab, g.n_superpixels, g.slic_compactness, g.slic_iters)
        gh, gw, _ = grid_shape(h, w, g.n_superpixels)
        # cv2's SLIC contract includes enforceLabelConnectivity
        # (slic.hpp:127-136); the device pass keeps every superpixel feeding
        # the affinity graph 4-connected without leaving jit
        n_sp = gh * gw
        sp = enforce_connectivity_device(sp, n_sp)
        fn = lambda f, s: ncut_regions(
            f, s, n_sp, g.n_regions, g.affinity_sigma, eig_method,
            g.affinity_sigma_scale,
        )
        regions = jax.vmap(fn)(features, sp)  # (B, S)
        # region ids back to pixels: a plain per-image gather
        return jax.vmap(lambda r, s: r[s])(regions, sp).astype(jnp.int32)
    raise ValueError(
        f"cut={g.cut!r} is host-side (see mincut_segment); use pipeline.segment_images"
    )


# ---------------------------------------------------------------------------
# Min-cut variant (host; Felzenszwalb-style greedy merge over superpixels)
# ---------------------------------------------------------------------------


def _adjacency_pairs(sp: np.ndarray) -> np.ndarray:
    """(H, W) labels -> (E, 2) unique adjacent superpixel pairs (4-conn)."""
    a = np.stack([sp[:, :-1].reshape(-1), sp[:, 1:].reshape(-1)], 1)
    b = np.stack([sp[:-1, :].reshape(-1), sp[1:, :].reshape(-1)], 1)
    e = np.concatenate([a, b])
    e = e[e[:, 0] != e[:, 1]]
    e.sort(axis=1)
    return np.unique(e, axis=0)


def mincut_segment(
    features: np.ndarray,
    sp: np.ndarray,
    k: float = 300.0,
    min_size: int = 10,
) -> np.ndarray:
    """Felzenszwalb merge on the superpixel graph (host).

    features: (H, W, D); sp: (H, W) superpixel labels. Edge weight = euclidean
    feature distance between superpixel means. Merge predicate: w <=
    min(Int(Ci) + k/|Ci|, Int(Cj) + k/|Cj|) (Int = max internal weight so
    far). A final pass absorbs regions smaller than min_size superpixels.
    Returns (H, W) int32 region labels (contiguous).
    """
    h, w, d = features.shape
    n_sp = int(sp.max()) + 1
    flat = features.reshape(-1, d).astype(np.float64)
    lab_flat = sp.reshape(-1)
    sums = np.zeros((n_sp, d))
    np.add.at(sums, lab_flat, flat)
    cnts = np.bincount(lab_flat, minlength=n_sp).astype(np.float64)
    means = sums / np.maximum(cnts, 1.0)[:, None]

    edges = _adjacency_pairs(sp)
    wts = np.linalg.norm(means[edges[:, 0]] - means[edges[:, 1]], axis=1)
    order = np.argsort(wts, kind="stable")

    parent = np.arange(n_sp)
    size = np.ones(n_sp)
    internal = np.zeros(n_sp)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for ei in order:
        a, b = find(edges[ei, 0]), find(edges[ei, 1])
        if a == b:
            continue
        wt = wts[ei]
        if wt <= min(internal[a] + k / size[a], internal[b] + k / size[b]):
            parent[b] = a
            size[a] += size[b]
            internal[a] = max(internal[a], internal[b], wt)

    # absorb small regions
    for ei in order:
        a, b = find(edges[ei, 0]), find(edges[ei, 1])
        if a != b and (size[a] < min_size or size[b] < min_size):
            parent[b] = a
            size[a] += size[b]

    roots = np.array([find(i) for i in range(n_sp)])
    _, regions = np.unique(roots, return_inverse=True)
    return regions[lab_flat].reshape(h, w).astype(np.int32)
