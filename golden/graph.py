"""Golden graph stage: numpy SLIC + scipy-eigh normalized cut.

Mirrors models/slic.py and models/graph.py stage-for-stage in numpy/scipy
(float64 accumulate) so the device path has an executable CPU oracle; a separate
sanity test cross-checks the spectral stage against sklearn
SpectralClustering on synthetic graphs.
"""

from __future__ import annotations

import numpy as np

from gabor_color_image_segmentation.models.slic import grid_shape
from golden.cluster import kmeans_golden


def slic_golden(
    lab: np.ndarray, n_superpixels: int, ruler: float = 10.0, n_iter: int = 10
) -> np.ndarray:
    """Numpy mirror of models.slic.slic (same init, same 9-candidate rule)."""
    h, w, _ = lab.shape
    gh, gw, s = grid_shape(h, w, n_superpixels)
    n_sp = gh * gw

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    px = np.concatenate([lab.astype(np.float32), yy[..., None], xx[..., None]], -1)
    flat = px.reshape(-1, 5)

    cy = (np.arange(gh, dtype=np.float32) + 0.5) * (h / gh)
    cx = (np.arange(gw, dtype=np.float32) + 0.5) * (w / gw)
    cyg, cxg = np.meshgrid(cy, cx, indexing="ij")
    iy = np.clip(cyg.astype(np.int32), 0, h - 1)
    ix = np.clip(cxg.astype(np.int32), 0, w - 1)
    init_color = lab[iy, ix].reshape(n_sp, 3)
    centroids = np.concatenate(
        [init_color, cyg.reshape(-1, 1), cxg.reshape(-1, 1)], -1
    ).astype(np.float32)

    cell_y = np.clip((yy * (gh / h)).astype(np.int32), 0, gh - 1)
    cell_x = np.clip((xx * (gw / w)).astype(np.int32), 0, gw - 1)
    offs = np.array([(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
    ny = np.clip(cell_y[..., None] + offs[:, 0], 0, gh - 1)
    nx = np.clip(cell_x[..., None] + offs[:, 1], 0, gw - 1)
    cand = (ny * gw + nx).reshape(-1, 9)

    spatial_w = np.float32((ruler / s) ** 2)

    def assign(centroids):
        c = centroids[cand]  # (N, 9, 5)
        d = ((c[..., :3] - flat[:, None, :3]) ** 2).sum(-1) + spatial_w * (
            (c[..., 3:] - flat[:, None, 3:]) ** 2
        ).sum(-1)
        best = np.argmin(d, axis=-1)
        return cand[np.arange(cand.shape[0]), best]

    for _ in range(n_iter):
        labels = assign(centroids)
        sums = np.zeros((n_sp, 5), np.float64)
        np.add.at(sums, labels, flat)
        cnts = np.bincount(labels, minlength=n_sp).astype(np.float64)
        upd = (sums / np.maximum(cnts, 1.0)[:, None]).astype(np.float32)
        centroids = np.where(cnts[:, None] > 0, upd, centroids)
    return assign(centroids).reshape(h, w).astype(np.int32)


def enforce_connectivity_golden(
    labels: np.ndarray,
    n_sp: int | None = None,
    min_size: int | None = None,
    s_max: int | None = None,
) -> np.ndarray:
    """Numpy mirror of models.slic.enforce_connectivity_device — the SAME
    cv2-shaped rule, bit for bit: components >= min_size survive and are
    renumbered densely in raster (root-pixel) order, capped at s_max;
    smaller fragments absorbed by Jacobi-iterated adoption with neighbor
    priority up, left, right, down."""
    from scipy import ndimage

    h, w = labels.shape
    n = h * w
    if n_sp is None:
        n_sp = int(labels.max()) + 1
    if min_size is None:
        min_size = max(1, n // n_sp // 4)
    if s_max is None:
        s_max = n_sp
    idx = np.arange(n, dtype=np.int64).reshape(h, w)
    comp = np.empty((h, w), np.int64)
    structure = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]])
    for v in np.unique(labels):
        mask = labels == v
        cc, ncc = ndimage.label(mask, structure=structure)
        mins = ndimage.minimum(idx, cc, index=np.arange(1, ncc + 1))
        comp[mask] = np.asarray(mins)[cc[mask] - 1]

    counts = np.bincount(comp.reshape(-1), minlength=n)  # size at root index
    roots = np.flatnonzero(counts >= min_size)  # surviving roots, raster order
    roots = roots[:s_max]
    newid = np.full(n, -1, np.int64)
    newid[roots] = np.arange(len(roots))
    lab = newid[comp].astype(np.int32)  # -1 on absorbed fragments
    kept = lab >= 0

    t = 0
    # h + w step guard, mirroring the device passes: never fires when any
    # survivor exists; all-absorbed degenerate inputs clamp to id 0
    while not kept.all() and t < h + w:
        t += 1
        cand = lab.copy()
        have = np.zeros_like(kept)

        def shift(x, dy, dx, fill):
            out = np.full_like(x, fill)
            ys = slice(max(0, -dy), h - max(0, dy))
            xs = slice(max(0, -dx), w - max(0, dx))
            yd = slice(max(0, dy), h - max(0, -dy))
            xd = slice(max(0, dx), w - max(0, -dx))
            out[ys, xs] = x[yd, xd]
            return out

        # reverse priority order so the first-listed neighbor wins
        for dy, dx in ((1, 0), (0, 1), (0, -1), (-1, 0)):  # down,right,left,up
            nl = shift(lab, dy, dx, 0)
            nk = shift(kept, dy, dx, False)
            cand = np.where(nk, nl, cand)
            have = have | nk
        adopt = (~kept) & have
        lab = np.where(adopt, cand, lab)
        kept = kept | adopt
    return np.maximum(lab, 0)


def ncut_golden(
    features: np.ndarray,
    sp: np.ndarray,
    n_regions: int,
    affinity_sigma: float | None = None,
    n_sp: int | None = None,
    sigma_scale: float = 1.0,
) -> np.ndarray:
    """Numpy/scipy mirror of models.graph: means -> affinity -> eigh -> kmeans."""
    h, w, d = features.shape
    if n_sp is None:
        n_sp = int(sp.max()) + 1
    flat = features.reshape(-1, d).astype(np.float64)
    lab_flat = sp.reshape(-1)
    sums = np.zeros((n_sp, d))
    np.add.at(sums, lab_flat, flat)
    cnts = np.bincount(lab_flat, minlength=n_sp).astype(np.float64)
    f = sums / np.maximum(cnts, 1.0)[:, None]

    sq = (f**2).sum(1)
    d2 = np.maximum(sq[:, None] - 2 * f @ f.T + sq, 0.0)
    if affinity_sigma is None:
        # sigma_scale mirrors GraphConfig.affinity_sigma_scale (models/
        # graph.py affinity_matrix — the bandwidth remedy); the 4x4-strided
        # median subsample above S=512 mirrors the device path's
        # (same elements, same statistic)
        d2m = d2[::4, ::4] if d2.shape[0] > 512 else d2
        s2 = max(np.median(d2m), 1e-12) * sigma_scale
    else:
        s2 = 2.0 * affinity_sigma**2
    wm = np.exp(-d2 / s2)
    # dead superpixels: zero row/col, NO self-loop — the degree clamp below
    # gives them L_sym row = identity (eigenvalue 1), keeping the bottom-k
    # eigenspace purely on alive nodes (mirrors models/graph.py
    # affinity_matrix; a self-loop made each dead node a zero-eigenvalue
    # isolated vertex and collapsed the cut on fragmented images)
    alive = (cnts > 0).astype(np.float64)
    wm = wm * alive[:, None] * alive[None, :]

    deg = wm.sum(1)
    dis = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    lsym = np.eye(n_sp) - dis[:, None] * wm * dis[None, :]
    _, evecs = np.linalg.eigh(lsym)
    emb = evecs[:, :n_regions]
    emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    regions, _ = kmeans_golden(emb.astype(np.float32), n_regions, n_iter=30)
    return regions[lab_flat].reshape(h, w).astype(np.int32)


def pool2x2_img_np(x: np.ndarray) -> np.ndarray:
    """(H, W, C) -> (H//2, W//2, C) exact 2x2 block means, the same ordered
    f32 sum as models/pipeline.py::_pool2x2_nhwc (((x00+x01)+(x10+x11))/4)."""
    h2, w2 = x.shape[0] // 2, x.shape[1] // 2
    g = x[: 2 * h2, : 2 * w2].astype(np.float32)
    s = (g[0::2, 0::2] + g[0::2, 1::2]) + (g[1::2, 0::2] + g[1::2, 1::2])
    return 0.25 * s


def graph_inputs_golden(
    rgb: np.ndarray,
    bank_cfg,
    cluster_cfg,
    pool: int = 0,
    color_space: str = "lab",
    bank=None,
):
    """Golden mirror of the pipeline's graph-branch inputs
    (models/pipeline.py::segment_batch, graph.enabled): full-resolution
    golden energies + color, 2x2-mean-pooled ``pool`` times BEFORE
    assembly (standardization moments measured on the pooled grid).
    Returns ((Hp, Wp, D) standardized feats, (Hp, Wp, 3) pooled Lab)."""
    from gabor_color_image_segmentation.ops.bank import make_bank
    from golden.features import (
        assemble_features_np,
        gabor_energies_golden,
        rgb_to_lab_np,
    )

    if bank is None:
        bank = make_bank(bank_cfg)
    if color_space == "lab":
        img = rgb_to_lab_np(rgb)
    else:
        img = rgb.astype(np.float32)
        if rgb.dtype == np.uint8:
            img = img / 255.0
    energies = gabor_energies_golden(img, bank)
    lab = img if color_space == "lab" else rgb_to_lab_np(rgb)
    for _ in range(pool):
        energies = pool2x2_img_np(energies)
        img = pool2x2_img_np(img)
        lab = img if color_space == "lab" else pool2x2_img_np(lab)
    return assemble_features_np(energies, img, cluster_cfg), lab
