"""Smoke test of the segmentation pipeline on NVIDIA GPUs.

    python chip_smoke.py          # one GPU: every preset, the eval entry
                                  # point and the Triton feature kernel
    python chip_smoke.py --four   # four GPUs: the data-parallel and
                                  # batch x space paths, nothing else

Run from the repository root. One process holds the card(s); the golden
(numpy) reference runs in the same process and ``nvidia-smi`` in a child
that never touches JAX. Any failed phase raises, so the script exits
non-zero; it exits non-zero without printing a result when JAX finds no
GPU. The last line of standard output is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

Tolerances (PARITY.md): labels agree with golden on one image per preset
after ``align_labels`` at >= 0.9995 in float32 parity mode (every f32 dot
and convolution at Precision.HIGHEST) and >= 0.999 in bfloat16 production
mode (bf16 operands, f32 accumulation, Precision.DEFAULT). The image is the
first whose golden labels are themselves stable at each mode's resolution
(see ``stable_golden``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

F32_BAR = 0.9995
BF16_BAR = 0.999
# Published sizes (BASELINE.json configs): preset -> batch. config4
# is 8 images of 2160x3840.
BATCH = {"config0": 1, "config1": 16, "config2": 8, "config3": 8, "config4": 8}
# config4's golden comparison runs on a cut size that still takes the tiled
# feature path (tile_hw 432x768) and the pooled cut chain: the numpy
# reference needs minutes per megapixel.
CONFIG4_GOLDEN_HW = (512, 768)
STEPS = 3
# golden stability probe (stable_golden): per mode, the relative feature
# noise at that mode's resolution and the bar the perturbed golden must hold
GOLDEN_NOISE = {"float32": (1e-7, F32_BAR), "bfloat16": (1e-3, BF16_BAR)}
# --four, config4 cut chain: the mesh-vs-one-GPU bar
# (tests/test_tiling.py::test_tiled_graph_equals_untiled) and the relative
# feature noise of the one-GPU stability screen (float32 rounding size)
FOUR_BAR = 0.9999
FOUR_NOISE = 1e-7


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def log(msg: str) -> None:
    print(msg, flush=True)


def mib(n) -> str:
    return f"{n / 2**20:.1f} MiB"


def memory_line(compiled) -> str:
    """The compiled program's sizes from memory_analysis()."""
    m = compiled.memory_analysis()
    return (
        f"args {mib(m.argument_size_in_bytes)}, out {mib(m.output_size_in_bytes)}, "
        f"temp {mib(m.temp_size_in_bytes)}, code {mib(m.generated_code_size_in_bytes)}"
    )


def peak_bytes() -> int:
    import jax

    return jax.devices()[0].memory_stats()["peak_bytes_in_use"]


def agreement(labels, ref) -> float:
    from gabor_color_image_segmentation.utils.labels import align_labels

    return float((align_labels(labels, ref) == ref).mean())


def check_labels(labels, shape, name: str) -> None:
    import numpy as np

    if labels.shape != shape or labels.dtype != np.int32:
        raise AssertionError(f"{name}: labels {labels.shape} {labels.dtype}, want {shape} int32")
    if labels.min() < 0:
        raise AssertionError(f"{name}: negative label")


def run_preset(cfg, batch, bank, tag: str):
    """One first call (compiles) and STEPS timed steps through
    segment_images: host uint8 in -> host int32 out. Returns the labels."""
    import numpy as np

    from gabor_color_image_segmentation.models.pipeline import segment_images

    t0 = time.perf_counter()
    labels = np.asarray(segment_images(batch, cfg, bank))
    t_first = time.perf_counter() - t0
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        labels = np.asarray(segment_images(batch, cfg, bank))
        times.append(time.perf_counter() - t0)
    check_labels(labels, batch.shape[:3], tag)
    step = sorted(times)[len(times) // 2]
    mp = batch.shape[0] * batch.shape[1] * batch.shape[2] / 1e6
    log(
        f"{tag}: batch {batch.shape}, compile ~{t_first - step:.1f} s (first "
        f"call {t_first:.2f} s minus one step), steady step {step * 1e3:.1f} ms "
        f"(median of {STEPS}; {mp / step:.2f} MP/s), peak_bytes_in_use "
        f"{mib(peak_bytes())} (whole process so far)"
    )
    return labels


def stable_golden(images, cfg, bank):
    """Golden labels of the first image (of up to three) that can certify
    both bars: golden labels that survive a relative perturbation of the
    features at each mode's resolution (GOLDEN_NOISE) at that mode's bar.
    On an image that fails, the reference itself lands elsewhere under
    rounding-sized changes, so no device result there means anything at
    the bar. Returns (index, labels)."""
    import numpy as np

    from golden.pipeline import golden_inputs, golden_labels

    for i in range(min(3, len(images))):
        t0 = time.perf_counter()
        feats, lab = golden_inputs(images[i], cfg, bank)
        gold = golden_labels(feats, lab, cfg)
        stable = True
        notes = []
        for dtype, (scale, bar) in GOLDEN_NOISE.items():
            for seed in range(2):
                noise = np.random.default_rng(seed).standard_normal(feats.shape)
                moved = golden_labels(
                    (feats * (1 + scale * noise)).astype(feats.dtype), lab, cfg
                )
                agree = agreement(moved, gold)
                notes.append(f"{scale:g} draw {seed}: {agree:.6f}")
                stable = stable and agree >= bar
        log(f"{cfg.name}: golden image {i} at {images.shape[1]}x{images.shape[2]} "
            f"in {time.perf_counter() - t0:.1f} s; golden vs golden on features "
            f"x (1 + s N(0,1)): {', '.join(notes)} -> "
            f"{'stable' if stable else 'unstable, next image'}")
        if stable:
            return i, gold
    raise AssertionError(f"{cfg.name}: no golden-stable image among the first 3")


def phase_presets():
    """Every preset at its published size in bf16 and fp32, compared with
    golden on one golden-stable image; config3 also at batch 1."""
    from gabor_color_image_segmentation.benchmark import build_batch
    from gabor_color_image_segmentation.config import preset
    from gabor_color_image_segmentation.dispatch import resolve_impls
    from gabor_color_image_segmentation.ops.bank import make_bank

    for name in ("config0", "config1", "config2", "config3", "config4"):
        base = preset(name)
        bank = make_bank(base.bank)
        batch = build_batch(base, BATCH[name])
        if name == "config4":
            gcfg = base.replace(image_hw=CONFIG4_GOLDEN_HW)
        else:
            gcfg = base
        # candidates: the first three seeded images (the batch's first rows)
        gbatch = build_batch(gcfg, 3)
        i, gold = stable_golden(gbatch, gcfg, bank)
        for dtype, bar in (("bfloat16", BF16_BAR), ("float32", F32_BAR)):
            cfg = base.replace(dtype=dtype)
            tag = f"{name} {dtype} (features {resolve_impls(cfg).feature})"
            labels = run_preset(cfg, batch, bank, tag)
            if name == "config1" and dtype == "bfloat16":
                from gabor_color_image_segmentation.models.pipeline import (
                    segment_batch,
                )

                compiled = segment_batch.lower(batch, cfg, bank, False).compile()
                log(f"{tag}: step memory_analysis {compiled.memory_analysis()}")
            if name == "config4":
                glabels = run_preset(gcfg.replace(dtype=dtype), gbatch, bank,
                                     f"{tag} at {CONFIG4_GOLDEN_HW}")[i]
            elif i < len(batch):
                glabels = labels[i]
            else:  # config0's batch is one image
                glabels = run_preset(cfg, gbatch[i:i + 1], bank,
                                     f"{tag} image {i}")[0]
            prec = "HIGHEST" if dtype == "float32" else "DEFAULT (bf16 operands)"
            agree = agreement(glabels, gold)
            log(f"{tag}: golden agreement on image {i} {agree:.6f} (bar >= "
                f"{bar}, matmul precision {prec})")
            if agree < bar:
                raise AssertionError(f"{tag}: golden agreement {agree} < {bar}")
            if name == "config3":
                # batch 1 through the same entry point, against golden too
                one = run_preset(cfg, gbatch[i:i + 1], bank, f"{tag} batch 1")
                agree1 = agreement(one[0], gold)
                log(f"{tag} batch 1: golden agreement on image {i} "
                    f"{agree1:.6f} (bar >= {bar}, matmul precision {prec})")
                if agree1 < bar:
                    raise AssertionError(f"{tag} batch 1: {agree1} < {bar}")


def phase_eval():
    """eval.evaluate on synthetic multi-ground-truth images (config3)."""
    from gabor_color_image_segmentation.config import preset
    from gabor_color_image_segmentation.data.synthetic import synthetic_dataset
    from gabor_color_image_segmentation.eval import evaluate

    cfg = preset("config3")
    summary = evaluate(synthetic_dataset(cfg.batch_size, seed=500), cfg)
    log(f"eval config3: {json.dumps(summary)}")
    if summary["n_failed"] or summary["mean_pri"] is None:
        raise AssertionError(f"eval failed: {summary}")


def phase_feature_kernel():
    """The Triton feature kernel at config1's real widths: against the
    plain XLA form, then config1 end to end with each implementation in
    turns (A B B A) in this process."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gabor_color_image_segmentation.benchmark import build_batch
    from gabor_color_image_segmentation.config import preset
    from gabor_color_image_segmentation.ops.bank import make_bank
    from gabor_color_image_segmentation.ops.color import rgb_to_lab
    from gabor_color_image_segmentation.ops.gabor_triton import (
        gabor_energies_triton,
    )
    from gabor_color_image_segmentation.ops.modulated import gabor_energies_mod

    base = preset("config1").replace(dtype="bfloat16")
    bank = make_bank(base.bank)
    batch = build_batch(base, BATCH["config1"])
    lab = jax.jit(lambda r: rgb_to_lab(r))(jnp.asarray(batch))
    ref = np.asarray(jax.jit(lambda x: gabor_energies_mod(x, bank, jnp.float32))(lab))
    scale = float(np.abs(ref).max())
    for dtype, bound in ((jnp.float32, 1e-4), (jnp.bfloat16, 2e-2)):
        f = jax.jit(lambda x: gabor_energies_triton(x, bank, dtype))
        t0 = time.perf_counter()
        compiled = f.lower(lab).compile()
        tc = time.perf_counter() - t0
        out = np.asarray(compiled(lab), np.float32)
        err = float(np.abs(out - ref).max()) / scale
        log(f"triton energies {jnp.dtype(dtype).name}: shape {out.shape}, compile "
            f"{tc:.1f} s, max |triton - modulated f32| / max|ref| = {err:.2e} "
            f"(bound {bound:g}); {memory_line(compiled)}")
        if not np.isfinite(out).all() or err > bound:
            raise AssertionError(f"triton kernel {jnp.dtype(dtype).name}: rel err {err}")

    from gabor_color_image_segmentation.models.pipeline import segment_images

    cfgs = {i: base.replace(feature_impl=i) for i in ("modulated", "triton")}
    for cfg in cfgs.values():
        np.asarray(segment_images(batch, cfg, bank))  # compile + warm
    times = {i: [] for i in cfgs}
    for impl in ("modulated", "triton", "triton", "modulated"):
        for _ in range(STEPS):
            t0 = time.perf_counter()
            np.asarray(segment_images(batch, cfgs[impl], bank))
            times[impl].append(time.perf_counter() - t0)
    for impl, ts in times.items():
        ts = sorted(ts)
        log(f"config1 bf16 end to end, features {impl}: median "
            f"{ts[len(ts) // 2] * 1e3:.1f} ms/batch-16 (min {ts[0] * 1e3:.1f}, "
            f"max {ts[-1] * 1e3:.1f}, {len(ts)} steps, A B B A)")


def ncut_screen(b4, cfg4, bank4, dev):
    """config4's cut chain on one GPU, untiled, for each image of ``b4``:
    its labels, and whether they hold at FOUR_BAR when the graph stage's
    input features are recomputed in a separate program and, in two draws,
    moved by FOUR_NOISE relative noise. The batch x space mesh differs from
    one GPU by the order of its psum reductions, i.e. by float32 rounding
    in the statistics; an image whose n-cut flips under changes of that
    size cannot certify the mesh at the bar. Returns (labels, stable)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gabor_color_image_segmentation.models.graph import graph_segment_batch
    from gabor_color_image_segmentation.models.pipeline import (
        _color_transform,
        _pool2x2_nhwc,
        segment_batch,
    )

    cfg1 = cfg4.replace(tile_hw=None)
    p = cfg4.graph.pool

    @jax.jit
    def moved(rgb, feats, key, scale):
        # the pooled Lab grid of segment_batch's graph branch
        lab = _color_transform(rgb, "lab")
        for _ in range(p):
            lab = _pool2x2_nhwc(lab)
        noise = jax.random.normal(key, feats.shape, feats.dtype)
        out = graph_segment_batch(feats * (1 + scale * noise), lab, cfg1)
        return jnp.repeat(jnp.repeat(out, 1 << p, axis=1), 1 << p, axis=2)

    labels, stable = [], []
    for i in range(0, len(b4), 2):  # pairs bound the untiled run's memory
        x = jax.device_put(b4[i:i + 2], dev)
        ref, feats = segment_batch(x, cfg1, bank4, True)
        ref = np.asarray(ref)
        draws = [np.asarray(moved(x, feats, jax.random.key(s), scale))
                 for s, scale in enumerate((0.0, FOUR_NOISE, FOUR_NOISE))]
        for j in range(len(ref)):
            agree = [agreement(d[j], ref[j]) for d in draws]
            ok = min(agree) >= FOUR_BAR
            log(f"config4 one GPU, image {i + j}: cut chain vs itself "
                f"recompiled {agree[0]:.6f}, with features x (1 + "
                f"{FOUR_NOISE:g} N(0,1)) {agree[1]:.6f}, {agree[2]:.6f} -> "
                f"{'stable' if ok else 'unstable'} at {FOUR_BAR}")
            labels.append(ref[j])
            stable.append(ok)
    return np.stack(labels), stable


def phase_four():
    """config1 data-parallel over four GPUs vs one GPU (bitwise), and
    config4's cut chain at its published batch on a (2, 2) batch x space
    mesh vs one GPU, on the images where one GPU's result is stable."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from gabor_color_image_segmentation.benchmark import build_batch
    from gabor_color_image_segmentation.config import preset
    from gabor_color_image_segmentation.models.pipeline import segment_batch
    from gabor_color_image_segmentation.ops.bank import make_bank
    from gabor_color_image_segmentation.parallel.sharding import (
        make_mesh,
        segment_batch_sharded,
    )
    from gabor_color_image_segmentation.parallel.tiling import (
        segment_tiled_batch,
    )

    devs = jax.devices()
    cfg = preset("config1").replace(dtype="bfloat16")
    bank = make_bank(cfg.bank)
    batch = build_batch(cfg, BATCH["config1"])
    # one GPU runs the per-device program shape (batch 16 / 4) four times,
    # so the comparison is bitwise
    q = batch.shape[0] // 4
    one = np.concatenate([
        np.asarray(segment_batch(
            jax.device_put(batch[i:i + q], devs[0]), cfg, bank, False)[0])
        for i in range(0, batch.shape[0], q)
    ])
    mesh = make_mesh(4)
    t0 = time.perf_counter()
    labels, _ = segment_batch_sharded(batch, cfg, bank, mesh, False)
    labels.block_until_ready()
    t_first = time.perf_counter() - t0
    used = len(labels.sharding.device_set)
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        labels = np.asarray(segment_batch_sharded(batch, cfg, bank, mesh, False)[0])
        times.append(time.perf_counter() - t0)
    step = sorted(times)[len(times) // 2]
    equal = bool((labels == one).all())
    log(f"config1 bf16 data-parallel on {used} GPUs, batch {batch.shape[0]}: "
        f"first call {t_first:.2f} s, steady step {step * 1e3:.1f} ms (median "
        f"of {STEPS}, host uint8 in to host int32 out), bitwise equal to one "
        f"GPU: {equal}")
    if used != 4 or not equal:
        raise AssertionError(f"data-parallel: {used} devices, equal={equal}")

    # the strips compute modulated energies with global phase coordinates,
    # as the untiled one-GPU run does (tile_hw=None: no window-relative
    # phases), so the two differ only in psum reduction order
    cfg4 = preset("config4").replace(dtype="float32", feature_impl="modulated")
    bank4 = make_bank(cfg4.bank)
    b4 = build_batch(cfg4, BATCH["config4"])
    ref, stable = ncut_screen(b4, cfg4, bank4, devs[0])
    mesh2 = Mesh(np.asarray(devs[:4]).reshape(2, 2), ("batch", "space"))
    t0 = time.perf_counter()
    out = segment_tiled_batch(b4, cfg4, bank4, mesh2)
    used = len(out.sharding.device_set)
    out = np.asarray(out)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = np.asarray(segment_tiled_batch(b4, cfg4, bank4, mesh2))
    step = time.perf_counter() - t0
    log(f"config4 f32 cut chain on a (2, 2) batch x space mesh ({used} GPUs), "
        f"batch {b4.shape[0]} at {b4.shape[1]}x{b4.shape[2]}: first call "
        f"{t_first:.2f} s, second call {step * 1e3:.1f} ms, repeat bitwise "
        f"equal: {bool((again == out).all())}")
    for i in range(b4.shape[0]):
        agree = agreement(out[i], ref[i])
        log(f"config4 mesh vs one GPU, image {i}: agreement {agree:.6f} "
            f"({'stable, bar > ' + str(FOUR_BAR) if stable[i] else 'unstable on one GPU, not gated'})")
        if stable[i] and not agree > FOUR_BAR:
            raise AssertionError(f"batch x space image {i}: {agree}")
    if used != 4 or not any(stable):
        raise AssertionError(f"batch x space: {used} devices, stable {stable}")
    log(f"config4 mesh: {sum(stable)} of {len(stable)} images stable on one "
        f"GPU, all of them above the bar")


def result_line(devs) -> str:
    """The last line: ok, and the devices as JAX reports them."""
    return json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs),
    }})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU data-parallel and batch x "
                         "space phases")
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: needs a GPU; jax backend is "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 2
    log(f"card: {card_line()}")
    from gabor_color_image_segmentation.utils.jit_cache import (
        enable_compilation_cache,
    )

    log(f"jax {jax.__version__}, devices {jax.devices()}, compile cache "
        f"{enable_compilation_cache()}")
    if args.four:
        if len(jax.devices()) < 4:
            raise RuntimeError(f"--four needs 4 GPUs, have {len(jax.devices())}")
        phases = [phase_four]
    else:
        phases = [phase_feature_kernel, phase_presets, phase_eval]
    t_all = time.perf_counter()
    for phase in phases:
        t0 = time.perf_counter()
        phase()
        log(f"phase {phase.__name__} done in {time.perf_counter() - t0:.1f} s")
    log(f"all phases done in {time.perf_counter() - t_all:.1f} s")
    print(result_line(jax.devices()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
