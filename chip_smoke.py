#!/usr/bin/env python3
"""Bring-up check: the VO engine's main path on NVIDIA GPUs.

    python chip_smoke.py               # one GPU: phases 0-7
    python chip_smoke.py --four-cards  # four GPUs: the multi-device paths

Phases, all in this one process (a failed phase raises, so the exit code is
non-zero and no result line is printed):

  0  identify the card, JAX, XLA_FLAGS and the compile cache
  1  KITTI stereo as shipped: BA-4, 1024-point map, 1536 keypoint slots
  2  EuRoC raw stereo rectified inside the step, 4096-point map
  3  TUM RGB-D freiburg1 with lens distortion, 8192-point map
  4  eight KITTI streams of different worlds in one MultiStreamVO
  5  the oracle golden scenarios with the tests' margins
  6  determinism: one KITTI chunk twice from the same state
  7  Hamming distances as a bf16 product vs XOR+popcount: exactness at
     real width and the full-step A/B behind config.hamming_matmul

``--four-cards`` runs only the multi-device paths (stream-sharded
MultiStreamVO, point-sharded ShardedStreamVO, the 2x2 StreamPointVO) and
their one-card comparisons. Frames come from seeded synthetic worlds at
each dataset's geometry, rendered by worker processes that never touch a
card. Every line with a number names the card and its power limit; the
last stdout line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
CONFIGS = REPO / "lvt_tpu" / "configs"

# Same frames through two compiled programs (per-frame step vs scanned
# chunk, one stream vs a vmapped or sharded batch) agree only to float
# rounding: XLA fuses and orders f32 arithmetic differently in each
# program, which moves LM iterates and, on float (rectified) frames, flips
# corner-selection ties, and tracking carries the difference forward.
# Measured over 32 chunked frames: 2.9 mm on the GPU (KITTI) and 11.8 mm on
# the CPU (EuRoC rectified). The bound is half the golden scenarios' 0.10 m
# ATE margin, so a pass still means agreement within the tracker's own
# accuracy bar; the drift observed is reported beside it.
POSE_TOL_M = 0.05
# ATE of each single-stream phase in a CPU run of the same frames and
# configuration (JAX_PLATFORMS=cpu, full size, on the GPU machine's host);
# the bound on the GPU adds the golden scenarios' ATE margins: x1.10 +
# 0.10 m.
CPU_ATE_M = {"kitti": 0.023670725700274564, "euroc": 0.10815885500837717,
             "tum": 0.011891117119129262}
ATE_REL, ATE_ABS_M = 1.10, 0.10
N_ONLINE, CHUNK, N_CHUNKS = 20, 16, 2


class SmokeFailure(AssertionError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# card and logging
# ---------------------------------------------------------------------------
def card_lines() -> list[str]:
    """nvidia-smi's name and power limit of every card, from a child
    process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def make_log(card: str):
    def log(msg: str) -> None:
        print(f"[{card}] {msg}", flush=True)
    return log


# ---------------------------------------------------------------------------
# configurations and worlds (jax-free: render workers import these)
# ---------------------------------------------------------------------------
def kitti_config():
    from lvt_tpu.config import load_config, load_kitti_calib

    calib = load_kitti_calib(str(CONFIGS / "kitti" / "00.yaml"))
    return load_config(str(CONFIGS / "kitti" / "vo_config.yaml"),
                       img_width=1241, img_height=376, **calib)


def euroc_config():
    from lvt_tpu.config import load_config
    from lvt_tpu.io.datasets import EUROC_BASELINE, EUROC_P, EUROC_SIZE

    return load_config(
        str(CONFIGS / "euroc" / "vo_config.yaml"),
        fx=float(EUROC_P[0, 0]), fy=float(EUROC_P[1, 1]),
        cx=float(EUROC_P[0, 2]), cy=float(EUROC_P[1, 2]),
        baseline=EUROC_BASELINE, img_width=EUROC_SIZE[0],
        img_height=EUROC_SIZE[1])


def tum_config():
    from lvt_tpu.config import load_config

    return load_config(str(CONFIGS / "tum_rgbd" / "config_tum1.yaml"))


def camera_of(cfg) -> dict:
    return dict(width=cfg.img_width, height=cfg.img_height, fx=cfg.fx,
                fy=cfg.fy, cx=cfg.cx, cy=cfg.cy, baseline=cfg.baseline)


def kitti_job(cfg, n, seed=7, speed=0.9, as_float=False):
    """Street-scale blob world (bench.py's) seen by the KITTI camera."""
    world = dict(camera_of(cfg), n_points=6000, extent_x=80.0,
                 extent_y=20.0, extent_z=160.0, seed=seed)
    return ("stereo", world, n, speed, None, as_float)


def euroc_job(cfg, n):
    """Blob world seen through the raw (distorted, unrectified) EuRoC
    cameras; the trajectory is the rectified left camera's."""
    from lvt_tpu.io import datasets as ds

    world = dict(camera_of(cfg), n_points=2500, extent_x=30.0,
                 extent_y=15.0, extent_z=60.0, seed=5)
    cams = ((ds.EUROC_KL, ds.EUROC_DL, ds.EUROC_RL),
            (ds.EUROC_KR, ds.EUROC_DR, ds.EUROC_RR))
    return ("stereo", world, n, 0.25, cams, False)


def tum_job(cfg, n):
    """Room-scale world (depth 2-5 m, inside the config's 5 m far plane)
    seen through the distorting freiburg1 lens; depth is registered to the
    distorted image, as a Kinect's is."""
    k = np.array([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1]])
    dist = (cfg.k1, cfg.k2, cfg.p1, cfg.p2, cfg.k3)
    world = dict(camera_of(cfg), n_points=1200, extent_x=2.5,
                 extent_y=1.2, extent_z=5.0, seed=3)
    return ("rgbd", world, n, 0.02, (k, dist, np.eye(3)), False)


def render(job):
    """Frames of one job: [(img1, img2, (R_c2w, t_c2w))]. Stereo images
    are uint8 (float32 with as_float); RGB-D depth is float32 metres."""
    kind = job[0]
    if kind == "scenario":
        from tools.oracle.scenarios import by_name

        return list(by_name(job[1]).frames())
    from lvt_tpu.io.synthetic import SyntheticWorld

    _, world_kw, n, speed, cams, as_float = job
    world = SyntheticWorld(**world_kw)
    if kind == "stereo":
        dt = np.float32 if as_float else np.uint8
        return [(a.astype(dt), b.astype(dt), rt) for a, b, rt in
                world.stereo_sequence(n, cameras=cams, speed=speed)]
    return [(a.astype(np.uint8), d.astype(np.float32), rt) for a, d, rt in
            world.rgbd_sequence(n, camera=cams, speed=speed)]


def render_pool(n_workers: int):
    """Spawned render workers. They import numpy and the jax-free world
    code only, and run with no visible GPU all the same."""
    saved = {k: os.environ.get(k) for k in ("JAX_PLATFORMS",
                                            "CUDA_VISIBLE_DEVICES")}
    os.environ.update(JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    try:
        return multiprocessing.get_context("spawn").Pool(n_workers)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def stack_frames(frames, i):
    """[N, H, W] array of field i (0: first image, 1: second) of frames."""
    return np.stack([f[i] for f in frames])


def stack_streams(streams):
    """Per-stream frame lists -> ([N, S, H, W] first, second images)."""
    n = len(streams[0])
    return tuple(
        np.stack([stack_frames([st[f] for st in streams], i)
                  for f in range(n)])
        for i in (0, 1))


def run_single(log, name, make_vo, frames, n_online, chunk, ate_bound):
    """Online ``track`` over every frame, and a second system that tracks
    the first n_online frames online and the rest with ``track_chunk``.
    Checks no LOST frame, ATE <= ate_bound and chunked == online poses.
    Returns (ate, chunk-vs-online max |dt|, the chunked system)."""
    from lvt_tpu.core.state import LOST
    from lvt_tpu.io.synthetic import ate_rmse

    check((len(frames) - n_online) % chunk == 0, "frames must fill chunks")
    online = make_vo()
    on_t, lost = [], 0
    for a, b, _ in frames:
        on_t.append(np.asarray(online.track(a, b).t))
        lost += int(online.state.status) == LOST
    chunked = make_vo()
    for a, b, _ in frames[:n_online]:
        chunked.track(a, b)
    ch_t = []
    for c0 in range(n_online, len(frames), chunk):
        blk = frames[c0:c0 + chunk]
        poses, metrics = chunked.track_chunk(stack_frames(blk, 0),
                                             stack_frames(blk, 1))
        ch_t.append(np.asarray(poses.t))
        lost += int(np.sum(np.asarray(metrics.status) == LOST))
    on_t = np.array(on_t)
    gt = np.array([f[2][1] for f in frames])
    ate = ate_rmse(on_t, gt)
    diff = float(np.max(np.abs(np.concatenate(ch_t) - on_t[n_online:])))
    dist = float(np.linalg.norm(gt[-1] - gt[0]))
    log(f"{name}: {len(frames)} frames over {dist:.6f} m: ATE {ate} m "
        f"(bound {ate_bound} m); chunked vs online max |dt| {diff} m "
        f"(tolerance {POSE_TOL_M} m); LOST frames {lost}")
    check(lost == 0, f"{name}: {lost} LOST frames")
    check(ate <= ate_bound, f"{name}: ATE {ate} m > bound {ate_bound} m")
    check(diff <= POSE_TOL_M, f"{name}: chunked poses differ by {diff} m")
    return ate, diff, chunked


def memory_line(compiled) -> str:
    m = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes",
              "generated_code_size_in_bytes")
    return ", ".join(f"{f}={getattr(m, f)}" for f in fields
                     if hasattr(m, f)) or repr(m)


def run_multistream(log, cfg, streams, chunk):
    """S streams of different worlds in one MultiStreamVO, chunked, vs a
    single-stream VOSystem over each stream's frames."""
    from lvt_tpu.core.state import LOST
    from lvt_tpu.core.system import VOSystem
    from lvt_tpu.parallel.multistream import MultiStreamVO

    s, n = len(streams), len(streams[0])
    il, ir = stack_streams(streams)
    msvo = MultiStreamVO(cfg, s)
    ms_t, lost = [], 0
    for c0 in range(0, n, chunk):
        poses, metrics = msvo.track_chunk(il[c0:c0 + chunk],
                                          ir[c0:c0 + chunk])
        ms_t.append(np.asarray(poses.t))
        lost += int(np.sum(np.asarray(metrics.status) == LOST))
    ms_t = np.concatenate(ms_t)                       # [N, S, 3]
    diffs = []
    for k in range(s):
        vo = VOSystem(cfg)
        ref = [np.asarray(vo.track_chunk(il[c0:c0 + chunk, k],
                                         ir[c0:c0 + chunk, k])[0].t)
               for c0 in range(0, n, chunk)]
        diffs.append(float(np.max(np.abs(np.concatenate(ref)
                                         - ms_t[:, k]))))
    spread = float(np.max(np.abs(ms_t[-1] - ms_t[-1, :1])))
    log(f"multistream S={s}: {n} frames per stream; LOST frames {lost}; "
        f"max |dt| vs single-stream {max(diffs)} m (tolerance "
        f"{POSE_TOL_M} m); final-position spread across streams {spread} m")
    check(lost == 0, f"multistream: {lost} LOST stream-frames")
    check(max(diffs) <= POSE_TOL_M,
          f"multistream: stream poses differ from single-stream by "
          f"{max(diffs)} m")
    check(spread > 0.0, "multistream: the streams did not differ")
    return max(diffs)


def run_goldens(log, scenario_frames):
    """The oracle golden scenarios through tests/test_parity_oracle.py's
    runner (tools/oracle/scenarios.run_lvt) and margins."""
    from tools.oracle.scenarios import by_name, parity_rows, run_lvt

    failures = []
    for name, frames in scenario_frames.items():
        sc = by_name(name)
        rows = parity_rows(sc, *run_lvt(sc, frames))
        log(f"golden {name}: " + "; ".join(
            f"{ax} {ours} {unit} (bound {bound}, oracle {oracle})"
            for ax, ours, bound, oracle, unit in rows))
        failures += [f"{name} {ax}" for ax, ours, bound, _, _ in rows
                     if ours > bound]
    check(not failures, f"goldens over their bound: {failures}")


def run_determinism(log, vo, frames):
    """One chunk twice from the same state; returns the max |difference|
    of the poses (0.0 when bit-identical)."""
    s0 = vo.state
    p1, _ = vo.track_chunk(stack_frames(frames, 0), stack_frames(frames, 1))
    vo.state = s0
    p2, _ = vo.track_chunk(stack_frames(frames, 0), stack_frames(frames, 1))
    a = np.concatenate([np.asarray(p1.t), np.asarray(p1.q)], -1)
    b = np.concatenate([np.asarray(p2.t), np.asarray(p2.q)], -1)
    same = bool(np.array_equal(a, b))
    diff = float(np.max(np.abs(a - b)))
    log(f"determinism: one {len(frames)}-frame chunk twice from one state: "
        f"bit-identical={same}, max |difference| {diff}")
    return diff


def run_hamming_exactness(log, m, k, seed=0):
    """bf16 +-1 product vs XOR+popcount vs numpy at [m, 8] x [k, 8]."""
    import jax
    import jax.numpy as jnp

    from lvt_tpu.ops import hamming

    rs = np.random.RandomState(seed)
    a = rs.randint(0, 2**32, (m, 8), dtype=np.uint64).astype(np.uint32)
    b = rs.randint(0, 2**32, (k, 8), dtype=np.uint64).astype(np.uint32)
    fn = jax.jit(hamming.hamming_matrix, static_argnames=("matmul",))
    prod = np.asarray(fn(jnp.asarray(a), jnp.asarray(b), matmul=True))
    pop = np.asarray(fn(jnp.asarray(a), jnp.asarray(b), matmul=False))
    bits = lambda x: np.unpackbits(x.view(np.uint8), axis=-1)
    ref = (bits(a)[:, None, :] != bits(b)[None, :, :]).sum(-1)
    err = int(max(np.abs(prod - ref).max(), np.abs(pop - ref).max()))
    log(f"hamming [{m}x{k}]: max |error| vs numpy {err} (tolerance 0) for "
        f"the bf16 product and XOR+popcount")
    check(err == 0, f"hamming distances off by {err}")


def time_hamming_ab(log, cfg, warm, timed, rounds=4):
    """Full-step A/B of config.hamming_matmul: each variant tracks the
    `warm` chunk (compiles, fills the map), then `timed` is tracked from
    that state in alternating A B B A order. Returns {flag: median
    ms/frame}."""
    import jax.numpy as jnp

    from lvt_tpu.core.system import VOSystem

    a = jnp.asarray(stack_frames(timed, 0))
    b = jnp.asarray(stack_frames(timed, 1))
    vos, states, times, poses = {}, {}, {False: [], True: []}, {}
    for flag in (False, True):
        vo = VOSystem(cfg.replace(hamming_matmul=flag))
        vo.track_chunk(stack_frames(warm, 0), stack_frames(warm, 1))
        vos[flag], states[flag] = vo, vo.state
    order = [False, True, True, False] * rounds
    for flag in order:
        vo = vos[flag]
        vo.state = states[flag]
        t0 = time.perf_counter()
        p, _ = vo.track_chunk(a, b)
        pt = np.asarray(p.t)
        times[flag].append((time.perf_counter() - t0) * 1e3 / len(timed))
        poses[flag] = pt
    med = {f: statistics.median(t) for f, t in times.items()}
    same = float(np.max(np.abs(poses[True] - poses[False])))
    log(f"hamming A/B in the full chunked step, M={cfg.max_map_points} "
        f"map points x K={cfg.kp_capacity} keypoints: XOR+popcount median "
        f"{med[False]} ms/frame {times[False]}, bf16 product median "
        f"{med[True]} ms/frame {times[True]}; pose max |dt| between "
        f"variants {same} m")
    return med


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------
def _peak_bytes(device) -> int:
    return device.memory_stats()["peak_bytes_in_use"]


def run_four_cards(log, devices, cfg, streams, chunk, shard_frames,
                   sp_streams, shard_cfg, peak_bytes=_peak_bytes):
    """Multi-device paths on exactly four devices, each against the same
    work on one device."""
    import jax
    from jax.sharding import Mesh

    from lvt_tpu.core.state import TRACKING
    from lvt_tpu.core.system import VOSystem
    from lvt_tpu.parallel import mesh as mesh_mod
    from lvt_tpu.parallel.multistream import MultiStreamVO
    from lvt_tpu.parallel.sharded_stream import ShardedStreamVO
    from lvt_tpu.parallel.stream_point import StreamPointVO

    check(len(devices) == 4, f"--four-cards needs 4 devices, found "
          f"{len(devices)}")
    s, n = len(streams), len(streams[0])
    il, ir = stack_streams(streams)

    def multistream(devs):
        msvo = MultiStreamVO(cfg, s, mesh=mesh_mod.stream_mesh(devs))
        out = [np.asarray(msvo.track_chunk(il[c0:c0 + chunk],
                                           ir[c0:c0 + chunk])[0].t)
               for c0 in range(0, n, chunk)]
        check(bool((msvo.status == TRACKING).all()),
              "streams not all TRACKING")
        return np.concatenate(out)

    sharded = multistream(devices)
    peaks = [peak_bytes(d) for d in devices]
    single = multistream(devices[:1])
    diff = float(np.max(np.abs(sharded - single)))
    log(f"four cards, MultiStreamVO S={s} sharded over 4 vs on device 0: "
        f"max |dt| {diff} m (tolerance {POSE_TOL_M} m); peak bytes in use "
        f"per card during the sharded run {peaks}")
    check(diff <= POSE_TOL_M, f"stream-sharded poses differ by {diff} m")
    check(min(peaks) >= 0.5 * max(peaks),
          f"streams not split evenly over the cards: {peaks}")

    svo = ShardedStreamVO(shard_cfg,
                          mesh=Mesh(np.array(devices), (mesh_mod.POINT_AXIS,)))
    ref = VOSystem(shard_cfg)
    d_shard = 0.0
    for a, b, _ in shard_frames:
        d_shard = max(d_shard, float(np.max(np.abs(
            np.asarray(svo.track(a, b).t) - np.asarray(ref.track(a, b).t)))))
    log(f"four cards, ShardedStreamVO map over 4 cards (psum/pmin) vs "
        f"unsharded VOSystem, {len(shard_frames)} frames: max |dt| "
        f"{d_shard} m (tolerance {POSE_TOL_M} m); map sizes "
        f"{svo.map_size} vs {ref.map_size}")
    check(d_shard <= POSE_TOL_M, f"point-sharded poses differ by {d_shard} m")
    check(svo.status == TRACKING, "point-sharded stream not TRACKING")

    ns, nf = len(sp_streams), len(sp_streams[0])
    spvo = StreamPointVO(cfg, ns,
                         mesh=mesh_mod.stream_point_mesh(2, 2, devices))
    refs = [VOSystem(cfg) for _ in range(ns)]
    d_sp = 0.0
    for f in range(nf):
        poses, _ = spvo.track(stack_frames([st[f] for st in sp_streams], 0),
                              stack_frames([st[f] for st in sp_streams], 1))
        for k, vo in enumerate(refs):
            p = vo.track(sp_streams[k][f][0], sp_streams[k][f][1])
            d_sp = max(d_sp, float(np.max(np.abs(np.asarray(poses.t[k])
                                                 - np.asarray(p.t)))))
    log(f"four cards, StreamPointVO on a 2x2 mesh vs {ns} unsharded "
        f"streams, {nf} frames: max |dt| {d_sp} m (tolerance {POSE_TOL_M} "
        f"m)")
    check(d_sp <= POSE_TOL_M, f"2x2-mesh poses differ by {d_sp} m")
    check(bool((spvo.status == TRACKING).all()), "2x2 streams not TRACKING")
    jax.block_until_ready(spvo.states.pose.t)


# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the multi-device paths, on 4 GPUs")
    args = p.parse_args(argv)

    import jax

    from lvt_tpu import runtime

    dev = runtime.require_gpu()
    cards = card_lines()
    for line in cards:
        print(line, flush=True)
    log = make_log(cards[0])
    cache = runtime.enable_compile_cache()
    log(f"phase 0: jax {jax.__version__}, device_kind {dev['kind']}, "
        f"{dev['count']} device(s), XLA_FLAGS={os.environ.get('XLA_FLAGS')!r}"
        f", compile cache {cache}")
    t_start = time.perf_counter()
    kitti = kitti_config()
    pool = render_pool(min(8, os.cpu_count() or 1))
    try:
        if args.four_cards:
            _main_four_cards(log, pool, kitti)
        else:
            _main_one_card(log, pool, kitti)
    finally:
        pool.terminate()
        pool.join()
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


def _main_one_card(log, pool, kitti) -> None:
    from lvt_tpu.core import step
    from lvt_tpu.core.system import SensorType, VOSystem
    from lvt_tpu.io import datasets as ds
    from lvt_tpu.ops.undistort import make_rectify_map
    from tools.oracle.scenarios import SCENARIOS

    euroc, tum = euroc_config(), tum_config()
    n = N_ONLINE + CHUNK * N_CHUNKS
    jobs = {"kitti": kitti_job(kitti, n), "euroc": euroc_job(euroc, n),
            "tum": tum_job(tum, n)}
    jobs.update({f"stream{k}": kitti_job(kitti, CHUNK * N_CHUNKS,
                                         seed=101 + k, speed=0.7 + 0.05 * k)
                 for k in range(8)})
    jobs.update({f"golden:{sc.name}": ("scenario", sc.name)
                 for sc in SCENARIOS})
    pending = {k: pool.apply_async(render, (j,)) for k, j in jobs.items()}
    bound = {k: v * ATE_REL + ATE_ABS_M for k, v in CPU_ATE_M.items()}

    def phase(num, fn):
        t0 = time.perf_counter()
        out = fn()
        log(f"PASS phase {num} in {time.perf_counter() - t0:.1f} s "
            f"(host clock, compilation included)")
        return out

    check(kitti.kp_capacity == 1536 and kitti.max_map_points == 1024
          and kitti.local_ba_window == 4, "KITTI config is not as shipped")
    kf = pending["kitti"].get()

    def phase1():
        _, _, vo = run_single(log, "phase 1 KITTI stereo BA-4", lambda:
                              VOSystem(kitti), kf, N_ONLINE, CHUNK,
                              bound["kitti"])
        compiled = step.track_step_stereo.lower(
            vo.state, kf[0][0], kf[0][1], config=kitti).compile()
        log(f"phase 1 track_step_stereo memory_analysis: "
            f"{memory_line(compiled)}")
        return vo
    kitti_vo = phase(1, phase1)

    def phase2():
        w, h = ds.EUROC_SIZE
        maps = (make_rectify_map(w, h, ds.EUROC_KL, ds.EUROC_DL, ds.EUROC_RL,
                                 ds.EUROC_P),
                make_rectify_map(w, h, ds.EUROC_KR, ds.EUROC_DR, ds.EUROC_RR,
                                 ds.EUROC_P))
        run_single(log, "phase 2 EuRoC rectified stereo", lambda: VOSystem(
            euroc, rectify_maps=maps), pending["euroc"].get(), N_ONLINE,
            CHUNK, bound["euroc"])
    check(euroc.max_map_points == 4096, "EuRoC map is not 4096 points")
    phase(2, phase2)

    check(tum.max_map_points == 8192 and abs(tum.k1) > 1e-5,
          "TUM config is not freiburg1 as shipped")
    phase(3, lambda: run_single(
        log, "phase 3 TUM RGB-D", lambda: VOSystem(tum, SensorType.RGBD),
        pending["tum"].get(), N_ONLINE, CHUNK, bound["tum"]))

    phase(4, lambda: run_multistream(
        log, kitti, [pending[f"stream{k}"].get() for k in range(8)], CHUNK))

    phase(5, lambda: run_goldens(log, {
        sc.name: pending[f"golden:{sc.name}"].get() for sc in SCENARIOS}))

    phase(6, lambda: run_determinism(log, kitti_vo, kf[-CHUNK:]))

    def phase7():
        run_hamming_exactness(log, kitti.max_map_points, kitti.kp_capacity)
        run_hamming_exactness(log, 4096, kitti.kp_capacity)
        for m in (1024, 4096):
            time_hamming_ab(log, kitti.replace(max_map_points=m),
                            kf[:CHUNK], kf[CHUNK:2 * CHUNK])
        log("phase 7: no hand-written kernel is on the GPU path; "
            f"config.hamming_matmul default is {kitti.hamming_matmul}")
    phase(7, phase7)


def _main_four_cards(log, pool, kitti) -> None:
    import jax

    s, n = 32, CHUNK * N_CHUNKS
    jobs = {f"stream{k}": kitti_job(kitti, n, seed=201 + k,
                                    speed=0.7 + 0.01 * k) for k in range(s)}
    jobs["shard"] = kitti_job(kitti, N_ONLINE, seed=7, as_float=True)
    pending = {k: pool.apply_async(render, (j,)) for k, j in jobs.items()}
    streams = [pending[f"stream{k}"].get() for k in range(s)]
    t0 = time.perf_counter()
    # the point-sharded map gets 4096 slots: per-shard headroom, as
    # parallel/sharded_stream.py requires for equality with one device
    run_four_cards(log, jax.devices(), kitti, streams, CHUNK,
                   pending["shard"].get(), streams[:2],
                   kitti.replace(max_map_points=4096,
                                 max_staged_points=4096))
    log(f"PASS four-card paths in {time.perf_counter() - t0:.1f} s "
        f"(host clock, compilation included)")


if __name__ == "__main__":
    sys.exit(main())
