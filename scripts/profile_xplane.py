"""Device trace of the chunked KITTI step, reduced to time per stage.

Captures a jax.profiler trace of bench-shaped work (the shipped KITTI
configuration, warmed, two 16-frame chunks; ``--descriptor-mode`` overrides
config.descriptor_mode) on the GPU and reduces the device events of the
traced window to

  * the device's busy and idle share (union of kernel intervals),
  * device time per named scope of the step (the jax.named_scope names in
    core/step.py and core/extract.py), with the perception stage's
    bytes floor beside it,
  * the top kernels by device time.

A kernel is matched to the HLO instruction it ran (its ``hlo_op`` stat, or
for kernels launched inside a CUDA graph, where that stat only says
"command_buffer", its own name: XLA names a fusion's kernel after the
instruction, "." turned to "_"); the instruction's op_name metadata in the
compiled HLO text, or for a fusion the metadata of the instructions it
fuses, gives the scope. Library kernels (cuBLAS, cuSOLVER) inside a CUDA
graph carry neither and count as "other". Writes the
summary, the compiled HLO text and a sample of raw device events under
--out.

Usage:
    python scripts/profile_xplane.py [--out chiprun_out/xplane]
                                     [--descriptor-mode dense|sparse|patch]
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import pathlib
import re
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

SCOPES = ("rectify", "perception", "corner_select_describe", "corner_select",
          "patch_extract", "describe_refine", "motion_predict",
          "map_matching", "pnp_solve", "map_bookkeeping", "staged_update",
          "triangulation", "local_ba")
PEAK_BYTES_S = {"NVIDIA H100 80GB HBM3": 3.35e12}   # H100 SXM data sheet
CHUNK = 16


def capture(out: pathlib.Path, mode: str | None):
    import jax
    import jax.numpy as jnp

    import chip_smoke as cs
    from lvt_tpu import runtime
    from lvt_tpu.core import step
    from lvt_tpu.core.system import VOSystem

    dev = runtime.require_gpu()
    runtime.enable_compile_cache()
    cfg = cs.kitti_config().replace(descriptor_mode=mode)
    frames = cs.render(cs.kitti_job(cfg, 3 * CHUNK))
    chunks = [(jnp.asarray(cs.stack_frames(frames[i:i + CHUNK], 0)),
               jnp.asarray(cs.stack_frames(frames[i:i + CHUNK], 1)))
              for i in range(0, 3 * CHUNK, CHUNK)]
    vo = VOSystem(cfg)
    np.asarray(vo.track_chunk(*chunks[0])[0].t)      # compile + warm
    hlo = step.track_chunk_stereo.lower(
        vo.state, *chunks[1], config=cfg).compile().as_text()
    jax.profiler.start_trace(str(out))
    t0 = time.perf_counter()
    for a, b in chunks[1:]:
        np.asarray(vo.track_chunk(a, b)[0].t)
    wall = time.perf_counter() - t0
    jax.profiler.stop_trace()
    return dev, cfg, hlo, wall


_INST = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=")
_COMP = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*\{\s*$")


def hlo_op_names(hlo_text: str) -> dict:
    """HLO instruction name -> op_name path (its own metadata, or for a
    fusion or call the most common scope among the called computation's
    instructions)."""
    meta, calls, comp_ops, comp = {}, {}, collections.defaultdict(list), None
    for line in hlo_text.splitlines():
        m = _COMP.match(line)
        if m and "=" not in line.split("(")[0]:
            comp = m.group(1)
            continue
        m = _INST.match(line)
        if not m:
            continue
        op = re.search(r'op_name="([^"]*)"', line)
        called = re.search(r"(?:calls|body)=%?([\w.\-]+)", line)
        if op:
            meta[m.group(1)] = op.group(1)
            comp_ops[comp].append(op.group(1))
        if called:
            calls[m.group(1)] = called.group(1)
    out = dict(meta)
    for inst, callee in calls.items():
        if inst in out:
            continue
        scopes = collections.Counter(scope_of(p) for p in comp_ops[callee])
        scopes.pop("other", None)
        if scopes:
            out[inst] = scopes.most_common(1)[0][0]
    return out


def kernel_path(hlo_names: dict, hlo_op: str, kernel: str) -> str:
    """op_name path of a kernel event (see the module docstring)."""
    if hlo_op in hlo_names:
        return hlo_names[hlo_op]
    norm = {k.replace(".", "_"): v for k, v in hlo_names.items()}
    key = re.sub(r"__\d+$", "", kernel)
    while key not in norm:
        m = re.match(r"(.*)_\d+$", key)
        if not m:
            return ""
        key = m.group(1)
    return norm[key]


def scope_of(path: str) -> str:
    """The innermost pipeline scope named in an op_name path."""
    for part in reversed(path.split("/")):
        if part in SCOPES:
            return part
    return "other"


def reduce(trace_dir: pathlib.Path, hlo_names: dict):
    import jax

    path = sorted(glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True))[-1]
    pd = jax.profiler.ProfileData.from_file(path)
    events, sample = [], []
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = {k: v for k, v in ev.stats}
                events.append((ev.start_ns, ev.duration_ns, ev.name, stats))
                if len(sample) < 40:
                    sample.append(f"{plane.name} | {line.name} | {ev.name} "
                                  f"| {ev.duration_ns} ns | {stats}")
    if not events:
        raise SystemExit(f"no device events in {path}")
    per_scope = collections.Counter()
    per_kernel = collections.Counter()
    kernel_scope = {}
    for _, dur, name, stats in events:
        scope = scope_of(kernel_path(hlo_names, str(stats.get("hlo_op")),
                                     name))
        per_scope[scope] += dur
        per_kernel[name] += dur
        kernel_scope[name] = scope
    spans = sorted((s, s + d) for s, d, _, _ in events)
    busy, cur_s, cur_e = 0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    top = per_kernel.most_common(25)
    return dict(n_events=len(events), busy_ns=busy, window_ns=window,
                per_scope=dict(per_scope.most_common()),
                top_kernels={k: [d, kernel_scope[k]] for k, d in top}), sample


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="chiprun_out/xplane")
    p.add_argument("--descriptor-mode", choices=("dense", "sparse", "patch"))
    args = p.parse_args()
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    dev, cfg, hlo, wall = capture(out, args.descriptor_mode)
    with gzip.open(out / "hlo.txt.gz", "wt") as f:
        f.write(hlo)
    summary, sample = reduce(out, hlo_op_names(hlo))
    frames = 2 * CHUNK
    h, w = cfg.img_height, cfg.img_width
    # perception reads two uint8 images and writes the raw and NMS score
    # maps (f32) and eight uint32 BRIEF planes per image
    floor_bytes = 2 * h * w * (1 + 4 + 4 + 32)
    peak = PEAK_BYTES_S.get(dev["kind"])
    summary.update(
        device=dev, descriptor_mode=args.descriptor_mode or "dense",
        frames=frames, host_wall_ms_per_frame=wall * 1e3 / frames,
        idle_share=1.0 - summary["busy_ns"] / summary["window_ns"],
        ms_per_frame_by_scope={k: v / 1e6 / frames
                               for k, v in summary["per_scope"].items()},
        perception_bytes_floor_per_frame=floor_bytes,
        perception_floor_ms_per_frame=(floor_bytes / peak * 1e3
                                       if peak else None),
    )
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    (out / "events_sample.txt").write_text("\n".join(sample))
    print(json.dumps({k: v for k, v in summary.items()
                      if k != "top_kernels"}, indent=1))
    for name, (dur, scope) in summary["top_kernels"].items():
        print(f"  {dur / 1e6 / frames:10.5f} ms/frame  {scope:22s} "
              f"{name[:90]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
