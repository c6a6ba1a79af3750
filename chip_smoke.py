"""Smoke run of the segment -> pixel -> cell -> spatial pipeline on NVIDIA GPUs.

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --four-gpus  # four cards: the FOV-sharded path only

Phases (one process drives the card; the CPU references run in the same
process on `jax.devices("cpu")`):

  mesmer_full  published Mesmer topology, random weights, bf16, 4 x 1024^2
               through `Mesmer.predict(postprocess="device")`; the f32
               forward compared with the CPU backend at 1 x 256^2
  segment      templates/1_segment_image_data.py on a synthetic 8-FOV
               1024^2 x 16-channel TIFF cohort with the shipped mini
               checkpoint; FOV 0 masks against the CPU backend, every cell
               table against a numpy/scipy.ndimage oracle
  watershed    Mesmer.predict, device vs host deep-watershed postprocess:
               equal up to co-optimal tie ownership
  pixel        templates/2_pixie_cluster_pixels.py; BMU against a float64
               argmin, channel percentiles against np.quantile
  cell         templates/3_pixie_cluster_cells.py; cell SOM assignment
               against a float64 argmin
  spatial      templates/spatial_enrichment.py against the CPU backend

The segment and pixel stages run twice and their artifacts are compared:
masks, pixel label columns and pixel cluster averages bitwise, cell-table
values within RUN_TO_RUN_RTOL of each column's scale (scatter-adds on the
GPU use atomics, so its float sums may change their last bits from run to
run). Every failed comparison raises, and any failure exits non-zero. The
last line of standard output is one JSON object naming the device; it is
printed only when every phase passed. Without a GPU the script exits
non-zero before any phase runs.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional, Tuple

REPO = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(REPO, "ark_tpu", "models", "checkpoints",
                    "mesmer_mini_synthetic.npz")


# run-to-run bounds on the cell table without `--xla_gpu_deterministic_ops`
# (README, "Compatibility contract"): max |difference| of a numeric column
# over that column's largest magnitude — any column, and the marker channel
# columns. Measured on H100s: at most 1.0e-5 and 1.1e-6 (PERF.md).
RUN_TO_RUN_RTOL = 1e-4
RUN_TO_RUN_CHANNEL_RTOL = 1e-5

# som_train_sharded's quantization error over single-device training's.
# Measured on 4 H100s: 1.078 in two runs, against a 1.2 % spread between
# two single-device seeds (PERF.md); the gap is open in ROADMAP.md.
SHARDED_QE_RATIO = 1.10


class SmokeFailure(AssertionError):
    """A phase produced a result outside its tolerance."""


@dataclasses.dataclass(frozen=True)
class Sizes:
    n_fovs: int = 8
    hw: int = 1024
    channels: int = 16
    n_cells: Tuple[int, int] = (900, 1000)
    crowding: float = 0.35
    full_batch: int = 4           # mesmer_full batch at hw x hw
    ref_hw: int = 256             # mesmer_full CPU comparison size
    full_config: Tuple = ()       # PanopticNet kwargs; () = published
    bmu_rows: int = 4_194_304
    max_k: int = 20
    seed: int = 0


REAL = Sizes()


# ---------------------------------------------------------------- helpers

def parse_nvidia_smi(text: str):
    """[(name, power limit)] from `--query-gpu=name,power.limit
    --format=csv,noheader` output."""
    cards = []
    for line in text.strip().splitlines():
        if line.strip():
            name, _, limit = line.rpartition(",")
            cards.append((name.strip(), limit.strip()))
    if not cards:
        raise SmokeFailure("nvidia-smi listed no card")
    return cards


def card_lines() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    parse_nvidia_smi(out)
    return out.strip()


def instance_f1(pred, truth, iou_threshold: float = 0.5) -> float:
    """F1 of instances matched one-to-one at IoU >= threshold (a match
    above 0.5 IoU is unique), from the label-pair contingency table."""
    import numpy as np

    pred = np.asarray(pred).ravel().astype(np.int64)
    truth = np.asarray(truth).ravel().astype(np.int64)
    n_p, n_t = int(pred.max()) + 1, int(truth.max()) + 1
    pair = np.bincount(pred * n_t + truth, minlength=n_p * n_t)
    inter = pair.reshape(n_p, n_t)
    area_p = np.bincount(pred, minlength=n_p)
    area_t = np.bincount(truth, minlength=n_t)
    p_ids, t_ids = np.nonzero(inter)
    keep = (p_ids > 0) & (t_ids > 0)
    p_ids, t_ids = p_ids[keep], t_ids[keep]
    i = inter[p_ids, t_ids]
    iou = i / (area_p[p_ids] + area_t[t_ids] - i)
    matched = int((iou >= iou_threshold).sum())
    n_pred = int((area_p[1:] > 0).sum())
    n_true = int((area_t[1:] > 0).sum())
    if n_pred + n_true == 0:
        return 1.0
    return 2.0 * matched / (n_pred + n_true)


def bmu_check(idx, data, weights, chunk: int = 1 << 18) -> Dict[str, float]:
    """Compare 0-indexed BMUs with a float64 argmin. Every disagreement must
    be a near tie: best-vs-second gap <= 1e-4 x mean ||x||^2."""
    import numpy as np

    idx = np.asarray(idx)
    w = np.asarray(weights, np.float64)
    x_all = np.asarray(data)
    tol = 1e-4 * float(np.mean(np.sum(x_all.astype(np.float64) ** 2, 1)))
    n_dis, worst = 0, 0.0
    for s in range(0, x_all.shape[0], chunk):
        x = x_all[s:s + chunk].astype(np.float64)
        d = (x * x).sum(1)[:, None] - 2.0 * x @ w.T + (w * w).sum(1)[None]
        ref = d.argmin(1)
        dis = np.nonzero(ref != idx[s:s + chunk])[0]
        if dis.size:
            rows = d[dis]
            gap = rows[np.arange(dis.size), idx[s + dis]] \
                - rows[np.arange(dis.size), ref[dis]]
            n_dis += dis.size
            worst = max(worst, float(gap.max()))
    agree = 1.0 - n_dis / max(x_all.shape[0], 1)
    if agree < 0.9999 or worst > tol:
        raise SmokeFailure(f"BMU agreement {agree:.6f} (limit 0.9999), worst "
                           f"disagreement gap {worst:.3e} (limit {tol:.3e})")
    return {"agreement": agree, "disagreements": n_dis,
            "worst_gap": worst, "gap_limit": tol}


def quant_oracle(labels, image):
    """Per-cell (ids, areas, channel sums) of an (H, W, C) image over an
    int label image, with scipy.ndimage."""
    import numpy as np
    import scipy.ndimage as ndi

    ids = np.unique(labels)
    ids = ids[ids > 0]
    areas = ndi.sum_labels(np.ones(labels.shape), labels, ids)
    sums = np.stack([ndi.sum_labels(image[..., c].astype(np.float64),
                                    labels, ids)
                     for c in range(image.shape[-1])], axis=1)
    return ids, areas, sums


def claim_levels(q, mask, markers, labels, ys, xs):
    """Minimax claim level of marker label `labels[i]` at pixel
    `(ys[i], xs[i])`: the lowest level t at which a 4-neighbor of the pixel
    lies in a 4-connected component of {mask & q <= t} that holds a marker
    pixel of that label (0 on the label's own marker pixels). This is the
    claim level of tests/ops/test_watershed_device.py, found level by level
    with scipy.ndimage instead of one Dijkstra per label. A label that never
    reaches the pixel gets `q.max() + 1`."""
    import numpy as np
    import scipy.ndimage as ndi

    labels, ys, xs = (np.asarray(a, np.int64) for a in (labels, ys, xs))
    out = np.full(labels.shape, int(q.max()) + 1, np.int64)
    own = mask[ys, xs] & (markers[ys, xs] == labels)
    out[own] = 0
    # work inside the bounding box of the mask components the queries touch
    comps = ndi.label(mask)[0]
    touched = np.zeros(int(comps.max()) + 1, bool)
    for dy, dx in ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1)):
        touched[comps[np.clip(ys + dy, 0, mask.shape[0] - 1),
                      np.clip(xs + dx, 0, mask.shape[1] - 1)]] = True
    touched[0] = False
    rows, cols = np.nonzero(touched[comps])
    if rows.size == 0:
        return out
    # the box with a one-pixel frame outside the mask, so every query has
    # 4 neighbors in it
    box = (slice(rows.min(), rows.max() + 1), slice(cols.min(), cols.max() + 1))
    q, mask, markers = (np.pad(a[box], 1) for a in (q, mask, markers))
    ys, xs = ys - rows.min() + 1, xs - cols.min() + 1
    # marker pixels of the queried labels, and each query's 4 neighbors
    my, mx = np.nonzero(np.isin(markers, np.unique(labels)) & mask)
    m_lab = markers[my, mx].astype(np.int64)
    ny = np.stack([ys + 1, ys - 1, ys, ys], 1)
    nx = np.stack([xs, xs, xs + 1, xs - 1], 1)
    pending = ~own
    for t in np.unique(q[mask]):
        if not pending.any():
            break
        comp, n = ndi.label(mask & (q <= t))
        m_comp = comp[my, mx]
        m_key = (m_lab * (n + 1) + m_comp)[m_comp > 0]
        idx = np.nonzero(pending)[0]
        n_comp = comp[ny[idx], nx[idx]]
        hit = np.isin(labels[idx, None] * (n + 1) + n_comp, m_key) \
            & (n_comp > 0)
        done = idx[hit.any(1)]
        out[done] = t
        pending[done] = False
    return out


def watershed_contract(dev, host, q, mask, markers,
                       min_agree: float = 0.99) -> Dict[str, float]:
    """The device flood's contract with the host flood on one image (the
    comparator of tests/ops/test_watershed_device.py): identical coverage,
    agreement >= min_agree on flooded pixels, and every disagreement a
    co-optimal tie — both labels claim the pixel at the same minimax level
    of the device's quantized relief `q`."""
    import numpy as np

    cover = int(((dev > 0) != (host > 0)).sum())
    flooded = host > 0
    dis = (dev != host) & flooded
    agree = 1.0 - float(dis.sum()) / max(int(flooded.sum()), 1)
    bad = 0
    if dis.any() and not cover:
        ys, xs = np.nonzero(dis)
        lv = claim_levels(q, mask, markers,
                          np.concatenate([dev[ys, xs], host[ys, xs]]),
                          np.tile(ys, 2), np.tile(xs, 2))
        bad = int((lv[:ys.size] != lv[ys.size:]).sum())
    res = {"coverage_mismatch_px": cover, "flooded_px": int(flooded.sum()),
           "disagreements": int(dis.sum()), "agreement": agree,
           "not_co_optimal": bad}
    if cover or bad or agree < min_agree:
        raise SmokeFailure(f"watershed: device and host floods differ "
                           f"beyond tie ownership: {res}")
    return res


def small_object_filter(labels, min_size: int):
    """Labels with fewer than `min_size` pixels zeroed, the others kept."""
    import numpy as np

    counts = np.bincount(labels.ravel())
    return np.where(counts[labels] < min_size, 0, labels)


def ulp_distance(a, b):
    """Distance in float32 units in the last place, elementwise."""
    import numpy as np

    def key(v):
        i = np.asarray(v, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(key(a) - key(b))


def files_equal(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def csv_drift(a_path: str, b_path: str) -> Dict[str, float]:
    """Run-to-run drift of one CSV written twice by the same stage, per
    numeric column: max |a - b| over the column's largest magnitude (so a
    derived feature near 0, such as the eccentricity of a round cell, is
    held to the scale of its column). Empty when the files are bitwise
    equal. Raises when shape, columns, text columns or NaN positions
    differ."""
    import numpy as np
    import pandas as pd

    if files_equal(a_path, b_path):
        return {}
    a, b = pd.read_csv(a_path), pd.read_csv(b_path)
    name = os.path.basename(a_path)
    if a.shape != b.shape or list(a.columns) != list(b.columns):
        raise SmokeFailure(f"{name}: {a.shape} vs {b.shape} between runs")
    num = list(a.select_dtypes("number").columns)
    text = [c for c in a.columns if c not in num]
    if not a[text].equals(b[text]):
        raise SmokeFailure(f"{name}: text columns differ between runs")
    x, y = a[num].to_numpy(np.float64), b[num].to_numpy(np.float64)
    if not np.array_equal(np.isnan(x), np.isnan(y)):
        raise SmokeFailure(f"{name}: NaN positions differ between runs")
    x, y = np.nan_to_num(x), np.nan_to_num(y)
    scale = np.maximum(np.abs(x).max(0, initial=0.0),
                       np.abs(y).max(0, initial=0.0))
    diff = np.abs(x - y).max(0, initial=0.0)
    return {c: float(d / max(m, 1e-30)) for c, d, m in zip(num, diff, scale)}


def check_drift(rep: "Report", phase: str, name: str,
                drift: Dict[str, float], channels):
    """Report one `csv_drift` result — the worst column, and the worst of
    the marker channels — and raise past the run-to-run bounds."""
    if not drift:
        rep.line(phase, artifact=name, run_to_run="bitwise")
        return
    worst = max(drift, key=drift.get)
    chan = max((drift[c] for c in channels if c in drift), default=0.0)
    rep.line(phase, artifact=name, drift=f"{drift[worst]:.3e}",
             column=worst, limit=RUN_TO_RUN_RTOL,
             channel_drift=f"{chan:.3e}", channel_limit=RUN_TO_RUN_CHANNEL_RTOL)
    if drift[worst] > RUN_TO_RUN_RTOL or chan > RUN_TO_RUN_CHANNEL_RTOL:
        raise SmokeFailure(f"{phase}: {name} drifts between runs")


def _template(name: str):
    spec = importlib.util.spec_from_file_location(
        f"template_{name}", os.path.join(REPO, "templates", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def memory_analysis(compiled) -> str:
    ma = compiled.memory_analysis()
    if ma is None:
        return "n/a"
    return " ".join(f"{k}={getattr(ma, k + '_size_in_bytes', 0)}"
                    for k in ("argument", "output", "temp",
                              "generated_code"))


class Report:
    """Phase lines on stdout; peak device memory after each phase."""

    def __init__(self, device):
        self.device = device

    def line(self, phase: str, **kv):
        body = " ".join(f"{k}={v}" for k, v in kv.items())
        print(f"[{phase}] {body}", flush=True)

    def peak(self, phase: str):
        stats = self.device.memory_stats() or {}
        self.line(phase, peak_bytes_in_use=stats.get("peak_bytes_in_use",
                                                     "n/a"))


@contextlib.contextmanager
def timed(out: dict, key: str):
    t0 = time.perf_counter()
    yield
    out[key] = time.perf_counter() - t0


# ---------------------------------------------------------------- cohort

def build_cohort(base: str, sizes: Sizes):
    """Synthetic cohort: planted cells (nuclear + membrane channels) and
    per-cell phenotype expression in the other channels, written as one
    float32 TIFF per channel per FOV under `base/image_data`. Returns the
    channel names."""
    import numpy as np

    from ark_tpu.io.image_utils import save_image
    from ark_tpu.segmentation import synthetic

    rng = np.random.default_rng(sizes.seed)
    # planted in 256^2 tiles: one call per FOV would stop placing cells
    # long before n_cells on a 1024^2 field
    tile = min(256, sizes.hw)
    per = sizes.hw // tile
    lo, hi = (max(1, n // (per * per)) for n in sizes.n_cells)
    imgs = np.zeros((sizes.n_fovs, sizes.hw, sizes.hw, 2), np.float32)
    cells = np.zeros((sizes.n_fovs, sizes.hw, sizes.hw), np.int32)
    for i in range(sizes.n_fovs):
        for ty in range(per):
            for tx in range(per):
                im, lab, _ = synthetic.synthetic_cells(
                    rng, 1, hw=tile, n_cells=(lo, hi),
                    crowding=sizes.crowding)
                sl = (i, slice(ty * tile, (ty + 1) * tile),
                      slice(tx * tile, (tx + 1) * tile))
                imgs[sl] = im[0]
                cells[sl] = np.where(lab[0] > 0, lab[0] + cells[i].max(), 0)
    channels = [f"chan{c}" for c in range(sizes.channels)]
    n_pheno = 5
    levels = rng.gamma(2.0, 1.0, (n_pheno, sizes.channels)) \
        * (rng.random((n_pheno, sizes.channels)) < 0.6)
    for i in range(sizes.n_fovs):
        fdir = os.path.join(base, "image_data", f"fov{i}")
        os.makedirs(fdir, exist_ok=True)
        pheno = rng.integers(0, n_pheno, int(cells[i].max()) + 1)
        inside = cells[i] > 0
        for c, name in enumerate(channels):
            if c < 2:
                img = imgs[i, :, :, c]
            else:
                img = np.where(inside, levels[pheno[cells[i]], c], 0.0)
                img = img * rng.gamma(4.0, 0.25, img.shape)
                img[rng.random(img.shape) < 0.002] += 0.5   # hot pixels
            save_image(os.path.join(fdir, f"{name}.tiff"),
                       img.astype(np.float32))
    return channels


def _clone_inputs(src: str, dst: str):
    os.makedirs(dst, exist_ok=True)
    os.symlink(os.path.join(src, "image_data"),
               os.path.join(dst, "image_data"))


# ---------------------------------------------------------------- phases

def _device_predict(app, batch, min_cell_size: int = 15):
    """`Mesmer.predict(postprocess="device")` with the host-flood fallback
    counted: returns (labels, fell_back)."""
    import jax.numpy as jnp

    pending = app._dispatch_device_post(jnp.asarray(batch, jnp.float32),
                                        0.1, 0.3, min_cell_size)
    fell_back = not bool(pending[1])
    return app._finish_device_post(pending), fell_back


def phase_mesmer_full(rep: Report, sizes: Sizes, cohort_imgs, cpu):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ark_tpu.segmentation import mesmer

    model, variables = mesmer.unet.init_mesmer(
        seed=0, dtype=jnp.bfloat16, **dict(sizes.full_config))
    app = mesmer.Mesmer(model=model, variables=variables)
    batch = cohort_imgs[:sizes.full_batch]
    t = {}
    xj = jnp.asarray(batch, jnp.float32)
    with timed(t, "compile_s"):
        compiled = app._segment_device_post.lower(
            app.variables, xj, jnp.float32(0.1), jnp.float32(0.3),
            jnp.int32(15)).compile()
    with timed(t, "first_s"):
        labels, fb1 = _device_predict(app, batch)
    with timed(t, "steady_s"):
        labels, fb2 = _device_predict(app, batch)
    n_cells = [int(len(np.unique(labels["whole_cell"][i])) - 1)
               for i in range(batch.shape[0])]
    rep.line("mesmer_full", batch=f"{batch.shape}", dtype="bfloat16",
             compile_s=f"{t['compile_s']:.3f}",
             first_call_s=f"{t['first_s']:.3f}",
             steady_s=f"{t['steady_s']:.3f}",
             host_flood_fallbacks=int(fb1) + int(fb2),
             whole_cell_instances=n_cells)
    rep.line("mesmer_full", program="_segment_device_post",
             memory=memory_analysis(compiled))

    # the same forward, f32 weights, against the CPU backend
    hw = sizes.ref_hw
    x = np.asarray(mesmer._percentile_normalize(
        jnp.asarray(batch[:1, :hw, :hw], jnp.float32)))
    model32 = dataclasses.replace(app.model, dtype=jnp.float32)
    fwd = jax.jit(lambda v, a, m=model32: m.apply(v, a, train=False))
    fwd16 = jax.jit(lambda v, a, m=app.model: m.apply(v, a, train=False))
    v_cpu = jax.device_put(app.variables, cpu)
    x_cpu = jax.device_put(x, cpu)
    with jax.default_matmul_precision("highest"):
        ref = jax.device_get(fwd(v_cpu, x_cpu))
        hi = jax.device_get(fwd(app.variables, jnp.asarray(x)))
    default = jax.device_get(fwd(app.variables, jnp.asarray(x)))
    bf16 = jax.device_get(fwd16(app.variables, jnp.asarray(x)))
    for head in sorted(ref):
        errs = {name: float(np.max(np.abs(np.asarray(out[head], np.float64)
                                          - np.asarray(ref[head]))))
                for name, out in (("highest", hi), ("default", default),
                                  ("bf16", bf16))}
        rep.line("mesmer_full", head=head,
                 f32_highest_err=f"{errs['highest']:.3e}", limit="1e-3",
                 f32_default_err=f"{errs['default']:.3e}",
                 bf16_err=f"{errs['bf16']:.3e}", limit_default_bf16="5e-2")
        if errs["highest"] > 1e-3 or errs["default"] > 5e-2 \
                or errs["bf16"] > 5e-2:
            raise SmokeFailure(f"mesmer_full {head}: {errs}")
    rep.peak("mesmer_full")


def _run_segment(base: str, channels):
    t1 = _template("1_segment_image_data")
    t1.main(base, [channels[0]], [channels[1]], weights_path=CKPT)


def phase_segment(rep: Report, work: str, sizes: Sizes, channels, cpu):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import pandas as pd

    from ark_tpu.io.image_utils import read_image
    from ark_tpu.segmentation import mesmer

    runs = [os.path.join(work, "run1"), os.path.join(work, "run2")]
    _clone_inputs(work, runs[1])
    t = {}
    with timed(t, "first_s"):
        _run_segment(work, channels)
    with timed(t, "second_s"):
        _run_segment(runs[1], channels)
    rep.line("segment", fovs=sizes.n_fovs, hw=sizes.hw,
             channels=sizes.channels, first_run_s=f"{t['first_s']:.3f}",
             steady_s=f"{t['second_s']:.3f}",
             compile_s_est=f"{t['first_s'] - t['second_s']:.3f}")
    seg = os.path.join(work, "segmentation", "deepcell_output")
    masks_same = all(files_equal(
        os.path.join(seg, f"fov{i}_{comp}.tiff"),
        os.path.join(runs[1], "segmentation", "deepcell_output",
                     f"fov{i}_{comp}.tiff"))
        for i in range(sizes.n_fovs) for comp in ("whole_cell", "nuclear"))
    rep.line("segment", artifact="masks", run_to_run="bitwise"
             if masks_same else "DIFFERENT")
    if not masks_same:
        raise SmokeFailure("segment: masks differ between runs")
    ct_dir = os.path.join("segmentation", "cell_table")
    for name in ("cell_table_size_normalized.csv",
                 "cell_table_arcsinh_transformed.csv"):
        check_drift(rep, "segment", name, csv_drift(
            os.path.join(work, ct_dir, name),
            os.path.join(runs[1], ct_dir, name)), channels)

    dc_in = os.path.join(work, "segmentation", "deepcell_input")
    # (a) FOV 0 masks from the same code on the CPU backend
    x0 = np.moveaxis(read_image(os.path.join(dc_in, "fov0.tiff")), 0, -1)
    with jax.default_device(cpu):
        app_cpu = mesmer.Mesmer(weights_path=CKPT)
        cpu_masks = app_cpu.predict(x0[None].astype(np.float32))
    app = mesmer.Mesmer(weights_path=CKPT)
    compiled = app._segment_device.lower(
        app.variables, jnp.asarray(x0[None], jnp.float32),
        jnp.float32(0.1)).compile()
    rep.line("segment", program="_segment_device",
             memory=memory_analysis(compiled))
    for comp in ("whole_cell", "nuclear"):
        gpu_mask = read_image(os.path.join(seg, f"fov0_{comp}.tiff"))
        f1 = instance_f1(gpu_mask, cpu_masks[comp][0])
        rep.line("segment", fov0_vs_cpu=comp, f1=f"{f1:.5f}", limit=0.99)
        if f1 < 0.99:
            raise SmokeFailure(f"segment: FOV 0 {comp} F1 {f1:.4f} vs CPU")

    # (b) cell tables against a numpy/scipy.ndimage oracle
    table = pd.read_csv(os.path.join(work, ct_dir,
                                     "cell_table_size_normalized.csv"))
    worst = 0.0
    for i in range(sizes.n_fovs):
        fov = f"fov{i}"
        labels = read_image(os.path.join(seg, f"{fov}_whole_cell.tiff"))
        image = np.stack([read_image(os.path.join(
            work, "image_data", fov, f"{c}.tiff")) for c in channels], -1)
        ids, areas, sums = quant_oracle(labels, image)
        rows = table[table["fov"] == fov].sort_values("label")
        if not np.array_equal(rows["label"].to_numpy(), ids) or \
                not np.array_equal(rows["cell_size"].to_numpy(), areas):
            raise SmokeFailure(f"segment: {fov} cell ids/areas differ from "
                               f"the oracle ({len(rows)} vs {len(ids)})")
        got = rows[channels].to_numpy(np.float64)
        want = sums / areas[:, None]
        err = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
        err = float(np.max(np.where(np.abs(want) > 0, err,
                                    np.abs(got - want))))
        worst = max(worst, err)
    rep.line("segment", cells=len(table), cell_table_vs_oracle_rtol=
             f"{worst:.3e}", limit="1e-5")
    if worst > 1e-5:
        raise SmokeFailure(f"segment: channel means rtol {worst:.3e}")
    rep.peak("segment")


def phase_watershed(rep: Report, work: str, sizes: Sizes):
    """`Mesmer.predict` with `postprocess="device"` and `"host"` on the
    same batches, as users call them (the device one timed, its host-flood
    fallbacks counted). Without the small-object filter (min_cell_size 0)
    every image meets the flood contract of
    tests/ops/test_watershed_device.py against the host labels: equal
    coverage, every disagreement a co-optimal minimax tie. With the default
    filter (15) each side's labels must be its own unfiltered labels less
    the objects under the size limit, so a coverage difference comes only
    from a tie moving pixels across that limit; it is bounded too."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import scipy.ndimage as ndi

    from ark_tpu.io.image_utils import read_image
    from ark_tpu.ops import watershed as W
    from ark_tpu.segmentation import mesmer

    min_size = 15
    dc_in = os.path.join(work, "segmentation", "deepcell_input")
    x = np.stack([np.moveaxis(read_image(os.path.join(
        dc_in, f"fov{i}.tiff")), 0, -1) for i in range(sizes.n_fovs)])
    x = x.astype(np.float32)
    app = mesmer.Mesmer(weights_path=CKPT)
    batches = [x[s:s + 4] for s in range(0, sizes.n_fovs, 4)]
    quantize = jax.jit(W._quantize, static_argnums=2)
    _device_predict(app, batches[0])                            # compile
    fallbacks, t = 0, {"predict_s": 0.0, "host_s": 0.0, "check_s": 0.0}
    worst = {"agreement": 1.0, "disagreements": 0}
    cover, cover_filtered, n_px = 0, 0, 0
    for batch in batches:
        dev = {}
        for m in (min_size, 0):
            t0 = time.perf_counter()
            dev[m], fell = _device_predict(app, batch, m)
            if m:
                t["predict_s"] += time.perf_counter() - t0
            fallbacks += int(fell)
        # Mesmer.predict(postprocess="host"), keeping its forward outputs
        t0 = time.perf_counter()
        fwd = app._segment_device(app.variables, jnp.asarray(batch),
                                  jnp.float32(0.1))
        host = {min_size: app._postprocess_device_out(fwd, 0.3, min_size)}
        t["host_s"] += time.perf_counter() - t0
        host[0] = app._postprocess_device_out(fwd, 0.3, 0)
        t0 = time.perf_counter()
        for comp in ("whole_cell", "nuclear"):
            mask = np.asarray(fwd[comp]["foreground"]) > 0.3
            q = np.asarray(quantize(-fwd[comp]["inner"], jnp.asarray(mask),
                                    mesmer._DEVICE_WATERSHED_LEVELS))
            maxima = np.asarray(fwd[comp]["maxima"])
            for b in range(batch.shape[0]):
                d0, h0 = dev[0][comp][b], host[0][comp][b]
                res = watershed_contract(d0, h0, q[b], mask[b],
                                         ndi.label(maxima[b])[0])
                worst["agreement"] = min(worst["agreement"], res["agreement"])
                worst["disagreements"] += res["disagreements"]
                cover += res["coverage_mismatch_px"]
                n_px += res["flooded_px"]
                for side, f, u in (("device", dev[min_size][comp][b], d0),
                                   ("host", host[min_size][comp][b], h0)):
                    if not np.array_equal(f, small_object_filter(u,
                                                                 min_size)):
                        raise SmokeFailure(
                            f"watershed: {side} min_cell_size={min_size} "
                            "labels are not its unfiltered labels less the "
                            "small objects")
                cover_filtered += int(((dev[min_size][comp][b] > 0)
                                       != (host[min_size][comp][b] > 0))
                                      .sum())
        t["check_s"] += time.perf_counter() - t0
    # measured on an H100: 4 px (several runs) and 22 px of 2.2M flooded
    filtered_limit = 1e-4 * n_px
    rep.line("watershed", fovs=sizes.n_fovs,
             predict_device_s=f"{t['predict_s']:.3f}",
             predict_host_s=f"{t['host_s']:.3f}",
             check_s=f"{t['check_s']:.3f}", host_flood_fallbacks=fallbacks)
    rep.line("watershed", min_cell_size=0, coverage_mismatch_px=cover,
             flooded_px=n_px, tie_disagreements=worst["disagreements"],
             all_ties_co_optimal=True, min_label_agreement=
             f"{worst['agreement']:.5f}", limit=0.99)
    rep.line("watershed", min_cell_size=min_size,
             filtered_as_unfiltered_less_small=True,
             coverage_mismatch_px=cover_filtered,
             limit=f"{filtered_limit:.1f}")
    if fallbacks or cover_filtered > filtered_limit:
        raise SmokeFailure(f"watershed: {fallbacks} host-flood fallbacks, "
                           f"{cover_filtered} px of filtered coverage "
                           "mismatch")
    rep.peak("watershed")


def _run_pixel(base: str, channels, seg_dir: str, sizes: Sizes):
    t2 = _template("2_pixie_cluster_pixels")
    t2.main(base, channels, seg_dir=seg_dir, max_k=sizes.max_k)


def phase_pixel(rep: Report, work: str, sizes: Sizes, channels):
    import jax.numpy as jnp
    import numpy as np
    import pandas as pd

    from ark_tpu.io import feather_utils as feather
    from ark_tpu.io.image_utils import read_image
    from ark_tpu.ops import som
    from ark_tpu.phenotyping import pixie_fused

    seg = os.path.join(work, "segmentation", "deepcell_output")
    run2 = os.path.join(work, "pixel_run2")
    _clone_inputs(work, run2)
    t = {}
    with timed(t, "first_s"):
        _run_pixel(work, channels, seg, sizes)
    with timed(t, "second_s"):
        _run_pixel(run2, channels, seg, sizes)
    rep.line("pixel", fovs=sizes.n_fovs, first_run_s=f"{t['first_s']:.3f}",
             steady_s=f"{t['second_s']:.3f}",
             compile_s_est=f"{t['first_s'] - t['second_s']:.3f}")
    label_cols = ["pixel_som_cluster", "pixel_meta_cluster"]
    n_rows = n_differ = 0
    for i in range(sizes.n_fovs):
        a, b = (feather.read_dataframe(os.path.join(
            base, "pixel_mat_data", f"fov{i}.feather"))[label_cols]
            for base in (work, run2))
        if len(a) != len(b):
            raise SmokeFailure(f"pixel: fov{i} keeps {len(a)} vs {len(b)} "
                               "pixels between runs")
        n_rows += len(a)
        n_differ += int((a.to_numpy() != b.to_numpy()).any(1).sum())
    name = "pixel_channel_avg_som_cluster.csv"
    avg_same = files_equal(os.path.join(work, name), os.path.join(run2, name))
    rep.line("pixel", artifact="feather label columns", rows=n_rows,
             run_to_run="bitwise" if not n_differ
             else f"DIFFERENT rows_differing={n_differ}")
    rep.line("pixel", artifact=name, run_to_run="bitwise" if avg_same
             else "DIFFERENT")
    if n_differ or not avg_same:
        raise SmokeFailure("pixel: labels or cluster averages differ "
                           "between runs")

    # (a) BMU on bmu_rows pixel rows x trained weights vs float64 argmin
    weights = feather.read_dataframe(os.path.join(
        work, "pixel_som_weights.feather"))
    cols = list(weights.columns)
    parts, n = [], 0
    for i in range(sizes.n_fovs):
        df = feather.read_dataframe(os.path.join(
            work, "pixel_mat_data", f"fov{i}.feather"))
        parts.append(df[cols].to_numpy(np.float32))
        n += len(df)
    rows = np.concatenate(parts)
    rows = np.resize(rows, (sizes.bmu_rows, len(cols)))
    w = weights.to_numpy(np.float32)
    compiled = som._bmu_idx.lower(jnp.asarray(w), jnp.asarray(rows)).compile()
    idx = np.asarray(som.som_map_async(w, rows))
    t0 = time.perf_counter()
    idx = np.asarray(som.som_map_async(w, rows))
    bmu_s = time.perf_counter() - t0
    res = bmu_check(idx, rows, w)
    rep.line("pixel", bmu_rows=rows.shape[0], nodes=w.shape[0],
             channels=w.shape[1], bmu_steady_s=f"{bmu_s:.4f}",
             **{k: (f"{v:.3e}" if isinstance(v, float) else v)
                for k, v in res.items()})
    rep.line("pixel", program="som._bmu_idx",
             memory=memory_analysis(compiled))

    # (b) channel 99th / 99.9th nonzero percentiles vs np.quantile
    image = np.stack([read_image(os.path.join(
        work, "image_data", "fov0", f"{c}.tiff")) for c in channels], -1)
    for q in (0.99, 0.999):
        got, _ = pixie_fused._channel_percentiles_device(
            jnp.asarray(image), q)
        got = np.asarray(got)
        want = np.array([np.quantile(image[..., c][image[..., c] > 0], q)
                         for c in range(image.shape[-1])], np.float32)
        ulps = int(ulp_distance(got, want).max())
        rep.line("pixel", percentile=q, max_ulp=ulps, limit=1)
        if ulps > 1:
            raise SmokeFailure(f"pixel: {q} percentiles off by {ulps} ulp")
    rep.peak("pixel")


def phase_cell(rep: Report, work: str, sizes: Sizes, channels):
    import numpy as np

    from ark_tpu.io import feather_utils as feather

    ct_path = os.path.join(work, "segmentation", "cell_table",
                           "cell_table_size_normalized.csv")
    t3 = _template("3_pixie_cluster_cells")
    t = {}
    with timed(t, "run_s"):
        cells = t3.main(work, channels, ct_path, max_k=sizes.max_k)
    weights = feather.read_dataframe(os.path.join(
        work, "cell_som_weights.feather"))
    cols = list(weights.columns)
    res = bmu_check(cells["cell_som_cluster"].to_numpy() - 1,
                    cells[cols].to_numpy(np.float32),
                    weights.to_numpy(np.float32))
    rep.line("cell", cells=len(cells), som_columns=len(cols),
             run_s=f"{t['run_s']:.3f}",
             meta_clusters=int(cells["cell_meta_cluster"].nunique()),
             **{k: (f"{v:.3e}" if isinstance(v, float) else v)
                for k, v in res.items()})
    rep.peak("cell")
    return cells


def phase_spatial(rep: Report, work: str, cells, cpu):
    import jax
    import numpy as np
    import pandas as pd

    table = pd.read_csv(os.path.join(work, "segmentation", "cell_table",
                                     "cell_table_size_normalized.csv"))
    table = table.merge(cells[["fov", "label", "cell_meta_cluster"]],
                        on=["fov", "label"], how="inner")
    te = _template("spatial_enrichment")
    out = {}
    for name, ctx in (("gpu", contextlib.nullcontext()),
                      ("cpu", jax.default_device(cpu))):
        base = os.path.join(work, f"spatial_{name}")
        os.makedirs(base, exist_ok=True)
        ct_path = os.path.join(base, "cell_table_clusters.csv")
        table.to_csv(ct_path, index=False)
        t0 = time.perf_counter()
        with ctx:
            te.main(base, ct_path)
        out[name] = (pd.read_csv(os.path.join(
            base, "spatial_enrichment_stats.csv")),
            time.perf_counter() - t0)
    g, c = out["gpu"][0], out["cpu"][0]
    keys = ["fov", "pheno1", "pheno2"]
    if not g[keys].equals(c[keys]):
        raise SmokeFailure("spatial: GPU and CPU tables list other pairs")
    obs_same = np.array_equal(g["close_num"].to_numpy(),
                              c["close_num"].to_numpy())
    errs = {}
    for col in ("muhat", "z"):
        a, b = g[col].to_numpy(np.float64), c[col].to_numpy(np.float64)
        ok = np.isfinite(a) & np.isfinite(b)
        if not np.array_equal(np.isfinite(a), np.isfinite(b)):
            raise SmokeFailure(f"spatial: {col} finite patterns differ")
        errs[col] = float(np.max(np.abs(a[ok] - b[ok])
                                 / np.maximum(np.abs(b[ok]), 1e-12),
                                 initial=0.0))
    rep.line("spatial", fovs=int(g["fov"].nunique()), rows=len(g),
             gpu_s=f"{out['gpu'][1]:.3f}", cpu_s=f"{out['cpu'][1]:.3f}",
             observed_exact=obs_same, null_mean_rtol=f"{errs['muhat']:.3e}",
             z_rtol=f"{errs['z']:.3e}", limit="1e-5")
    if not obs_same or max(errs.values()) > 1e-5:
        raise SmokeFailure("spatial: GPU and CPU enrichment differ")
    rep.peak("spatial")


def run_all(sizes: Sizes, device, cpu, workdir: Optional[str] = None):
    """Every single-card phase, in order, on `device`."""
    import jax
    import numpy as np

    from ark_tpu.io.image_utils import read_image

    rep = Report(device)
    with tempfile.TemporaryDirectory(dir=workdir) as work, \
            jax.default_device(device):
        t0 = time.perf_counter()
        channels = build_cohort(work, sizes)
        rep.line("cohort", fovs=sizes.n_fovs, hw=sizes.hw,
                 channels=sizes.channels, build_s=f"{time.perf_counter() - t0:.3f}")
        imgs = np.stack([np.stack([read_image(os.path.join(
            work, "image_data", f"fov{i}", f"{c}.tiff"))
            for c in channels[:2]], -1)
            for i in range(min(sizes.full_batch, sizes.n_fovs))])
        phase_mesmer_full(rep, sizes, imgs, cpu)
        phase_segment(rep, work, sizes, channels, cpu)
        phase_watershed(rep, work, sizes)
        phase_pixel(rep, work, sizes, channels)
        cells = phase_cell(rep, work, sizes, channels)
        phase_spatial(rep, work, cells, cpu)


def run_four(sizes: Sizes, devices):
    """The FOV-sharded path over a 1-D mesh of `devices`, against one
    device: `run_pixel_cohort` / `run_fiber_cohort` labels identical,
    `make_sharded_train_step` within rtol 1e-5, `som_train_sharded`
    quantization error within SHARDED_QE_RATIO of single-device
    training."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from ark_tpu.ops import som
    from ark_tpu.parallel import cohort

    rep = Report(devices[0])
    mesh_n = Mesh(np.array(devices), ("fov",))
    mesh_1 = Mesh(np.array(devices[:1]), ("fov",))
    rng = np.random.default_rng(sizes.seed)
    with tempfile.TemporaryDirectory() as work:
        build_cohort(work, sizes)
        from ark_tpu.io.image_utils import read_image
        imgs = np.stack([np.stack([read_image(os.path.join(
            work, "image_data", f"fov{i}", f"chan{c}.tiff"))
            for c in range(sizes.channels)], -1)
            for i in range(sizes.n_fovs)])
    norms = np.array([np.quantile(imgs[..., c][imgs[..., c] > 0], 0.999)
                      for c in range(sizes.channels)], np.float32)
    w = rng.random((100, sizes.channels)).astype(np.float32) * 0.2
    kw = dict(channel_norms=norms, pixel_thresh=0.05,
              post_norms=np.ones(sizes.channels, np.float32), som_weights=w)
    t = {}
    out = {}
    for name, mesh in (("n", mesh_n), ("1", mesh_1)):
        cohort.run_pixel_cohort(imgs, mesh=mesh, **kw)        # compile
        with timed(t, f"pixel_{name}"):
            out[name] = cohort.run_pixel_cohort(imgs, mesh=mesh, **kw)
    same = np.array_equal(out["n"]["som_clusters"], out["1"]["som_clusters"])
    rep.line("four_gpus", path="run_pixel_cohort", devices=len(devices),
             fovs=imgs.shape, sharded_s=f"{t['pixel_n']:.3f}",
             one_device_s=f"{t['pixel_1']:.3f}",
             labels_identical=same)
    if not same:
        raise SmokeFailure("four_gpus: sharded pixel labels differ")

    fib = {}
    for name, mesh in (("n", mesh_n), ("1", mesh_1)):
        cohort.run_fiber_cohort(imgs[..., 0], mesh=mesh)
        with timed(t, f"fiber_{name}"):
            fib[name] = cohort.run_fiber_cohort(imgs[..., 0], mesh=mesh)
    keys = sorted(fib["n"])
    same = all(np.array_equal(fib["n"][k], fib["1"][k]) for k in keys)
    rep.line("four_gpus", path="run_fiber_cohort", outputs=keys,
             sharded_s=f"{t['fiber_n']:.3f}",
             one_device_s=f"{t['fiber_1']:.3f}", identical=same)
    if not same:
        raise SmokeFailure("four_gpus: sharded fiber outputs differ")

    pix = out["1"]["pixel_mat"][out["1"]["valid"]]
    x = pix[rng.permutation(pix.shape[0])[:max(
        len(devices) * 1024, min(pix.shape[0], 1 << 18))]]
    x = x[:(x.shape[0] // len(devices)) * len(devices)]
    gdist = jnp.asarray(som.grid_distances(10, 10))
    args = (jnp.asarray(w), jnp.asarray(x), jnp.float32(0.05),
            jnp.float32(2.0), gdist)
    w_n = np.asarray(som.make_sharded_train_step(mesh_n)(*args))
    w_1 = np.asarray(som.make_sharded_train_step(mesh_1)(*args))
    err = float(np.max(np.abs(w_n - w_1) / np.maximum(np.abs(w_1), 1e-6)))
    rep.line("four_gpus", path="make_sharded_train_step", rows=x.shape[0],
             rtol=f"{err:.3e}", limit="1e-5")
    if err > 1e-5:
        raise SmokeFailure("four_gpus: sharded SOM step differs")

    held = pix[rng.permutation(pix.shape[0])[:65536]]
    with timed(t, "som_n"):
        w_sh = som.som_train_sharded(x, mesh_n, seed=42)
    qe_sh = float(som.som_map(w_sh, held)[1].mean())
    # the single-device trainer at two seeds, for the seed-to-seed spread
    qe_si, qe_seed = (float(som.som_map(som.som_train(x, seed=sd), held)[1]
                            .mean()) for sd in (42, 7))
    rep.line("four_gpus", path="som_train_sharded", rows=x.shape[0],
             sharded_s=f"{t['som_n']:.3f}", qe_sharded=f"{qe_sh:.6e}",
             qe_single=f"{qe_si:.6e}", qe_single_seed7=f"{qe_seed:.6e}",
             limit=f"{SHARDED_QE_RATIO} x single")
    if not qe_sh <= SHARDED_QE_RATIO * qe_si:
        raise SmokeFailure("four_gpus: sharded SOM quantization error")
    rep.peak("four_gpus")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-gpus", action="store_true",
                   help="run only the FOV-sharded path, on four cards")
    args = p.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "ark_tpu")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import ark_tpu  # noqa: F401  (sets the compile cache and XLA_FLAGS
    import jax      # defaults before the first backend exists)

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devices[0].platform})",
              file=sys.stderr)
        return 1
    want = 4 if args.four_gpus else 1
    if len(devices) < want:
        print(f"chip_smoke: needs {want} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 1
    print(card_lines(), flush=True)
    print(f"device_kind={devices[0].device_kind} count={len(devices)}")
    print(f"compile_cache={jax.config.jax_compilation_cache_dir}")
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')}", flush=True)
    t0 = time.perf_counter()
    if args.four_gpus:
        run_four(REAL, devices[:4])
    else:
        run_all(REAL, devices[0], jax.devices("cpu")[0])
    print(f"total_s={time.perf_counter() - t0:.3f}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
