"""JAX SLIC superpixels (SURVEY.md C10) — batched local k-means.

Semantics follow cv2.ximgproc SuperpixelSLIC (slic.hpp:64-161): grid-seeded
centroids in (L, a, b, y, x) space, ``iterate(n)`` rounds of local
assignment + centroid update, compactness ``ruler`` balancing color vs
spatial distance with the cell size s as the spatial normalizer.

Formulation: the classic "each centroid scans a 2s x 2s window" is
scatter-heavy, so each pixel instead gathers its 9 candidate centroids (its
3x3 neighbour cells — the same candidate set) and takes the one at the
least SLIC distance, computed directly in f32 like the golden mirror
(ties -> lowest cell id). The update step is a one-hot matmul scatter-mean. Labels are flat grid-cell
ids in [0, gh*gw). ``slic_batch`` is the batched entry point; the whole
stage is exact f32 (every dot pins HIGHEST).

Connectivity enforcement — inherently sequential flood fill in the
reference (slic.hpp enforceLabelConnectivity) — has two implementations:

* ``enforce_connectivity_device`` (jit/batch, used by the config3 graph
  path): cv2's semantics — split into 4-connected components (prefix-
  doubling run-min sweeps to a fixed point), renumber components >=
  min_size densely in raster order (capped at s_max so graph tensors stay
  static), absorb smaller fragments into adjacent surviving regions by
  deterministic neighbor-priority propagation.
  golden/graph.py::enforce_connectivity_golden mirrors the rule
  bit-for-bit for parity tests.
* ``enforce_connectivity`` (host, scipy): the same cv2-shaped split +
  min-size absorption, used by the host min-cut route.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def grid_shape(h: int, w: int, n_superpixels: int) -> Tuple[int, int, float]:
    """Choose the seed grid (gh, gw) and cell size s for a target count."""
    s = math.sqrt(h * w / n_superpixels)
    gh = max(1, round(h / s))
    gw = max(1, round(w / s))
    return gh, gw, s


# The exact-XLA SLIC semantics, factored so the single-chip ``slic`` and the
# row-sharded ``parallel/tiled_graph.slic_sharded`` share ONE source for the
# distance/candidate/tie-break/update math. The sharded caller passes a
# global row offset and wraps the moments in lax.psum; every other op is
# byte-for-byte these helpers.

# DEFAULT-precision f32 dots may round their inputs (TF32 on the GPU), so
# the moments dot pins HIGHEST.
_HI = jax.lax.Precision.HIGHEST
# candidate cells of a pixel: its 3x3 neighbourhood in raster order, so the
# first minimum is the lowest cell id (golden/graph.py uses the same order)
_OFFSETS = np.array([(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)])


def slic_geometry(h: int, w: int, n_superpixels: int, ruler: float):
    """(gh, gw, spatial_w): seed grid + the f32 weight of squared spatial
    distances, (ruler / s)^2."""
    gh, gw, s = grid_shape(h, w, n_superpixels)
    return gh, gw, float(np.float32((ruler / s) ** 2))


def slic_seed_coords(h: int, w: int, gh: int, gw: int):
    """Cell-center seed coordinates: ((gh, gw) cy, cx float grids,
    (gh, gw) iy, ix int pixel indices of the color sample)."""
    cy = (jnp.arange(gh, dtype=jnp.float32) + 0.5) * (h / gh)
    cx = (jnp.arange(gw, dtype=jnp.float32) + 0.5) * (w / gw)
    cyg, cxg = jnp.meshgrid(cy, cx, indexing="ij")
    iy = jnp.clip(cyg.astype(jnp.int32), 0, h - 1)
    ix = jnp.clip(cxg.astype(jnp.int32), 0, w - 1)
    return cyg, cxg, iy, ix


def slic_pixel_arrays(
    lab: jnp.ndarray, h: int, w: int, gh: int, gw: int, row0=0
):
    """(rows, W, 3) Lab (the full image, or a strip when ``row0`` is the
    strip's global first row) -> (flat (N, 5) [L,a,b,y,x] pixel features,
    cand (N, 9) int32 candidate centroid ids: the pixel's 3x3 neighbour
    cells, clipped at the grid border — the classic SLIC candidate set).
    Row coordinates are GLOBAL."""
    rows = lab.shape[0]
    yy = (row0 + jnp.arange(rows)).astype(jnp.float32).reshape(-1, 1)
    xx = jnp.arange(w, dtype=jnp.float32).reshape(1, -1)
    yb = jnp.broadcast_to(yy, (rows, w))
    xb = jnp.broadcast_to(xx, (rows, w))
    # 5-D pixel features: (rows, W, 5) = [L, a, b, y, x]
    px = jnp.concatenate(
        [lab.astype(jnp.float32), yb[..., None], xb[..., None]], -1
    )
    flat = px.reshape(-1, 5)
    # each pixel's home grid cell -> its 3x3 candidate cells
    cell_y = jnp.clip((yb * (gh / h)).astype(jnp.int32), 0, gh - 1).reshape(-1, 1)
    cell_x = jnp.clip((xb * (gw / w)).astype(jnp.int32), 0, gw - 1).reshape(-1, 1)
    ny = jnp.clip(cell_y + _OFFSETS[:, 0], 0, gh - 1)
    nx = jnp.clip(cell_x + _OFFSETS[:, 1], 0, gw - 1)
    return flat, (ny * gw + nx).astype(jnp.int32)


def slic_assign(
    flat: jnp.ndarray, centroids: jnp.ndarray, cand: jnp.ndarray,
    spatial_w: float,
) -> jnp.ndarray:
    """(N, 5) pixels + (S, 5) centroids + (N, 9) candidates -> (N,) labels.

    The SLIC distance ||lab_c - lab_p||^2 + spatial_w ||yx_c - yx_p||^2 to
    each candidate, computed directly (the same f32 formula as
    golden/graph.py::slic_golden, so near-ties resolve alike); ties go to
    the first candidate, the lowest cell id."""
    c = centroids[cand]  # (N, 9, 5)
    d = jnp.sum(jnp.square(c[..., :3] - flat[:, None, :3]), axis=-1) + (
        jnp.float32(spatial_w)
        * jnp.sum(jnp.square(c[..., 3:] - flat[:, None, 3:]), axis=-1)
    )
    best = jnp.argmin(d, axis=-1)
    return jnp.take_along_axis(cand, best[:, None], axis=1)[:, 0]


def slic_moments(labels: jnp.ndarray, flat: jnp.ndarray, n_sp: int):
    """Per-centroid (sums (S, 5), counts (S,)) of the assigned pixels.

    One-hot matmul (S, N) @ (N, 5). The sharded caller psums these before
    ``slic_update`` — everything else is local."""
    onehot = jax.nn.one_hot(labels, n_sp, dtype=jnp.float32)  # (N, S)
    sums = jnp.dot(
        onehot.T, flat, preferred_element_type=jnp.float32, precision=_HI
    )
    cnts = jnp.sum(onehot, axis=0)
    return sums, cnts


def slic_update(
    centroids: jnp.ndarray, sums: jnp.ndarray, cnts: jnp.ndarray
) -> jnp.ndarray:
    """Centroid step with the empty-cluster rule (keep the previous one)."""
    new = sums / jnp.maximum(cnts, 1.0)[:, None]
    return jnp.where(cnts[:, None] > 0, new, centroids)


@partial(jax.jit, static_argnums=(1, 2, 3))
def slic(
    lab: jnp.ndarray,
    n_superpixels: int,
    ruler: float = 10.0,
    n_iter: int = 10,
) -> jnp.ndarray:
    """(H, W, 3) Lab image -> (H, W) int32 superpixel labels in [0, gh*gw).

    vmap over a leading batch axis for batched execution.
    """
    h, w, _ = lab.shape
    gh, gw, spatial_w = slic_geometry(h, w, n_superpixels, ruler)
    n_sp = gh * gw
    flat, cand = slic_pixel_arrays(lab, h, w, gh, gw)

    # initial centroids at cell centers
    cyg, cxg, iy, ix = slic_seed_coords(h, w, gh, gw)
    init_color = lab[iy, ix].reshape(n_sp, 3)
    centroids = jnp.concatenate(
        [init_color, cyg.reshape(-1, 1), cxg.reshape(-1, 1)], axis=-1
    )  # (S, 5)

    def body(_, centroids):
        labels = slic_assign(flat, centroids, cand, spatial_w)
        sums, cnts = slic_moments(labels, flat, n_sp)
        return slic_update(centroids, sums, cnts)

    centroids = lax.fori_loop(0, n_iter, body, centroids)
    return slic_assign(flat, centroids, cand, spatial_w).reshape(h, w).astype(
        jnp.int32
    )


def slic_batch(
    lab: jnp.ndarray,
    n_superpixels: int,
    ruler: float = 10.0,
    n_iter: int = 10,
) -> jnp.ndarray:
    """(B, H, W, 3) Lab -> (B, H, W) int32 superpixel labels (vmapped
    ``slic``)."""
    return jax.vmap(lambda l: slic(l, n_superpixels, ruler, n_iter))(lab)


# ---------------------------------------------------------------------------
# Device (jit/batch) connectivity enforcement — the config3 graph path
# ---------------------------------------------------------------------------


def _shift1d(x: jnp.ndarray, k: int, axis: int, fill) -> jnp.ndarray:
    """out[i] = x[i - k] along ``axis`` (k may be negative), ``fill`` outside."""
    nd = x.ndim
    pad = [(0, 0)] * nd
    pad[axis] = (max(0, k), max(0, -k))
    xp = jnp.pad(x, pad, constant_values=fill)
    starts = [0] * nd
    starts[axis] = max(0, -k)
    sizes = list(x.shape)
    return lax.dynamic_slice(xp, starts, sizes)


def _run_extreme(
    vals: jnp.ndarray, keys: jnp.ndarray, axis: int, mode: str
) -> jnp.ndarray:
    """Min or max of ``vals`` over each position's maximal equal-``keys`` run
    along ``axis``.

    Prefix-doubling with static shifts (log2(n) unrolled steps of shifted
    select/min — pure elementwise ops XLA fuses well).
    """
    n = vals.shape[axis]
    if mode == "min":
        fill, combine = _RUN_BIG, jnp.minimum
    else:
        fill, combine = -_RUN_BIG, jnp.maximum
    out = vals
    for direction in (1, -1):
        same = _shift1d(keys, direction, axis, -1) == keys  # neighbor in-run
        v, ok = vals, same
        k = 1
        while k < n:
            v = jnp.where(ok, combine(v, _shift1d(v, direction * k, axis, fill)), v)
            ok = ok & _shift1d(ok, direction * k, axis, False)
            k *= 2
        out = combine(out, v)
    return out


# plain int, NOT jnp.int32: a module-level jax.Array gets captured as a
# trace constant, and under shard_map jax 0.9 stamps the capturing mesh
# onto its aval — reusing it under a different mesh (chip_smoke.py --four
# runs a 1-D then a 2-D mesh in one process) then fails with "context mesh
# ... should match the aval mesh"
_RUN_BIG = 2**30


def _pass_extreme(
    vals: jnp.ndarray, keys: jnp.ndarray, mode: str
) -> jnp.ndarray:
    """One H-then-V run-extreme sweep over (B, H, W) arrays."""
    v = _run_extreme(vals, keys, axis=2, mode=mode)
    return _run_extreme(v, keys, axis=1, mode=mode)


def connected_components(labels: jnp.ndarray) -> jnp.ndarray:
    """(B, H, W) int32 labels -> (B, H, W) int32 component ids.

    4-connected components of equal-label regions; each component's id is
    the minimum flat pixel index it contains (so ids are deterministic and
    directly comparable with the numpy mirror). Alternating row/column
    run-min sweeps iterate to a fixed point inside jit — each sweep moves
    the min across a whole same-label run, so convergence needs one
    iteration per "bend" of the component shape, not per pixel."""
    b, h, w = labels.shape
    comp0 = jnp.broadcast_to(
        jnp.arange(h * w, dtype=jnp.int32).reshape(1, h, w), (b, h, w)
    )

    def cond(state):
        _, changed = state
        return changed

    def body(state):
        comp, _ = state
        new = _pass_extreme(comp, labels, "min")
        return new, jnp.any(new != comp)

    comp, _ = lax.while_loop(
        cond, body, (_pass_extreme(comp0, labels, "min"), True)
    )
    return comp


def _propagate_in_components(seed: jnp.ndarray, comp: jnp.ndarray) -> jnp.ndarray:
    """Spread each component's root value to all its pixels.

    seed: (B, H, W) int32, the value at each component's root pixel and -1
    elsewhere -> every pixel of the component carries the root's value
    (run-max sweeps over equal-``comp`` runs to a fixed point; a root value
    reaches any pixel along the same scan path that built ``comp``)."""

    def cond(state):
        _, changed = state
        return changed

    def body(state):
        v, _ = state
        new = _pass_extreme(v, comp, "max")
        return new, jnp.any(new != v)

    v, _ = lax.while_loop(cond, body, (_pass_extreme(seed, comp, "max"), True))
    return v


def _shift2d(x: jnp.ndarray, dy: int, dx: int, fill) -> jnp.ndarray:
    """out[..., y, x] = x[..., y+dy, x+dx], ``fill`` outside the image."""
    pad = [(0, 0)] * (x.ndim - 2) + [
        (max(0, -dy), max(0, dy)),
        (max(0, -dx), max(0, dx)),
    ]
    xp = jnp.pad(x, pad, constant_values=fill)
    h, w = x.shape[-2], x.shape[-1]
    y0 = max(dy, 0)  # start into the padded array: top pad absorbs dy < 0
    x0 = max(dx, 0)
    return lax.slice(
        xp, (0,) * (x.ndim - 2) + (y0, x0),
        xp.shape[:-2] + (y0 + h, x0 + w),
    )


@partial(jax.jit, static_argnums=(1, 2, 3))
def enforce_connectivity_device(
    labels: jnp.ndarray,
    n_sp: int,
    min_size: int | None = None,
    s_max: int | None = None,
) -> jnp.ndarray:
    """(B, H, W) int32 SLIC labels -> (B, H, W) 4-connected superpixels,
    cv2 ``enforceLabelConnectivity`` semantics (slic.hpp:127-136):

      1. 4-connected components of equal labels (``connected_components``).
      2. Components of >= ``min_size`` pixels (default: cell area / 4, like
         the host pass) SURVIVE and are renumbered densely in raster order
         of their root pixels — cv2 renumbers the same way, so a label
         split into several large fragments yields several superpixels.
      3. Smaller components are absorbed by iterated adoption: a non-kept
         pixel takes the label of its first kept 4-neighbor in the fixed
         priority up, left, right, down (Jacobi update — all adoptions in
         an iteration read the previous state). Adoption only attaches
         pixels to already-connected regions, so the output is 4-connected
         by construction.

    Output ids lie in [0, s_max); ``s_max`` (default n_sp, keeping every
    downstream graph tensor's shape unchanged) caps the survivor count —
    raster-later survivors beyond the cap are absorbed instead
    (deterministic, mirrored by the golden pass; in practice survivors
    ~<= n_sp since min-size absorption removes far more ids than splitting
    adds — cv2 itself renumbers into a caller budget the same way).

    Mirrored bit-for-bit by golden/graph.py::enforce_connectivity_golden.
    """
    b, h, w = labels.shape
    n = h * w
    if min_size is None:
        min_size = max(1, n // n_sp // 4)
    if s_max is None:
        s_max = n_sp

    comp = connected_components(labels)
    bidx = jnp.broadcast_to(jnp.arange(b)[:, None], (b, n))
    comp_flat = comp.reshape(b, n)
    idx = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None], (b, n))
    is_root = comp_flat == idx  # component ids ARE root flat indices
    # component sizes land at root pixels (aligned — no gather needed)
    counts = jnp.zeros((b, n), jnp.int32).at[bidx, comp_flat].add(1)
    survives = is_root & (counts >= min_size)
    newid = jnp.cumsum(survives.astype(jnp.int32), axis=1) - 1  # raster order
    survives = survives & (newid < s_max)
    seed = jnp.where(survives, newid, -1).reshape(b, h, w)
    lab = _propagate_in_components(seed, comp)  # -1 on absorbed fragments

    kept = lab >= 0

    # guarded at h + w steps: any
    # absorbed pixel is within that L1 distance of a kept one whenever a
    # survivor exists, so the cap never fires on normal inputs (bit-equal);
    # in the all-absorbed degenerate case (e.g. pure noise, every component
    # below min_size) nothing is adoptable and an unguarded loop spins
    # forever — leftovers clamp to id 0 instead. golden mirrors the rule.
    def cond(state):
        _, kept, t = state
        return (~jnp.all(kept)) & (t < h + w)

    def body(state):
        lab, kept, t = state
        cand = lab
        have = jnp.zeros_like(kept)
        # reverse priority order so the first-listed neighbor wins the where
        for dy, dx in ((1, 0), (0, 1), (0, -1), (-1, 0)):  # down,right,left,up
            nl = _shift2d(lab, dy, dx, 0)
            nk = _shift2d(kept, dy, dx, False)
            cand = jnp.where(nk, nl, cand)
            have = have | nk
        adopt = (~kept) & have
        return jnp.where(adopt, cand, lab), kept | adopt, t + 1
    lab, _, _ = lax.while_loop(cond, body, (lab, kept, jnp.int32(0)))
    return jnp.maximum(lab, 0)


def enforce_connectivity(labels: np.ndarray, min_size: int | None = None) -> np.ndarray:
    """Host post-pass mirroring SuperpixelSLIC::enforceLabelConnectivity:
    split disconnected fragments of a label, absorb fragments smaller than
    min_size (default: cell area / 4) into their largest adjacent component.

    Returns contiguous int32 labels.
    """
    from scipy import ndimage

    h, w = labels.shape
    n_in = int(labels.max()) + 1
    if min_size is None:
        min_size = max(1, (h * w) // n_in // 4)

    # connected components per label value (4-connectivity, SLIC convention)
    comp = np.full((h, w), -1, np.int32)
    n_comp = 0
    structure = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]])
    for v in range(n_in):
        mask = labels == v
        if not mask.any():
            continue
        cc, n = ndimage.label(mask, structure=structure)
        comp[mask] = cc[mask] + n_comp - 1
        n_comp += n

    sizes = np.bincount(comp.reshape(-1), minlength=n_comp)

    # absorb small components into the most-adjacent large neighbor, looping
    # because absorption can chain (tiny fragment rings)
    out = comp.copy()
    for _ in range(4):
        sizes = np.bincount(out.reshape(-1))
        small = np.flatnonzero(sizes < min_size)
        if small.size == 0:
            break
        small_set = np.zeros(sizes.size, bool)
        small_set[small] = True
        # horizontal + vertical neighbor pairs with differing components
        pairs = []
        a, b = out[:, :-1].reshape(-1), out[:, 1:].reshape(-1)
        m = a != b
        pairs.append(np.stack([a[m], b[m]], 1))
        a, b = out[:-1, :].reshape(-1), out[1:, :].reshape(-1)
        m = a != b
        pairs.append(np.stack([a[m], b[m]], 1))
        pr = np.concatenate(pairs)
        pr = np.concatenate([pr, pr[:, ::-1]])  # symmetric
        # for each small comp, count adjacency to each neighbor; pick argmax
        m = small_set[pr[:, 0]]
        pr = pr[m]
        if pr.size == 0:
            break
        key = pr[:, 0].astype(np.int64) * sizes.size + pr[:, 1]
        uk, cnt = np.unique(key, return_counts=True)
        order = np.argsort(-cnt, kind="stable")
        uk, cnt = uk[order], cnt[order]
        src = (uk // sizes.size).astype(np.int32)
        dst = (uk % sizes.size).astype(np.int32)
        # first occurrence per src = neighbor with max shared boundary
        first = np.unique(src, return_index=True)[1]
        mapping = np.arange(sizes.size, dtype=np.int32)
        mapping[src[first]] = dst[first]
        out = mapping[out]

    # relabel contiguous
    _, out = np.unique(out, return_inverse=True)
    return out.reshape(h, w).astype(np.int32)
