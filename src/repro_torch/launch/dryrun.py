"""Multi-pod dry run: trace every (arch x shape x mesh) cell on fake
tensors.

PyTorch counterpart of ``repro.launch.dryrun``. For each cell this
shows, without hardware:

  * the sharding coheres: the parameters, optimizer state, decode state
    and batch are DTensors placed by the mesh rules on a 256- or
    512-rank ``DeviceMesh`` over a fake process group, and the port's
    own step function runs on them under DTensor's sharding propagation
    (the counterpart of GSPMD);
  * what each chip holds (memory_analysis: arguments, outputs, donated
    state, peak temporaries) and whether that `fits` in one H100's
    80 GiB of HBM;
  * and what a step costs per chip (``launch.op_analysis``: FLOPs, the
    eager op stream's bytes, the step's least bytes, collective wire
    bytes by kind).

Where DTensor cannot lower a view of a sharded tensor, the analysis
replicates the mesh axes it names and retries: `reshards` counts those
forced reshards (their ops are listed in `op_analysis.reshards`), so a
plan that needed them says so.

Nothing is allocated on any device: every tensor is fake. A cell that
cannot be traced is recorded as ``status: "error"`` with the op that
failed and the traceback; it never falls back to plain tensors.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k \
      [--multi-pod] [--dp-compress int8]
  python -m repro_torch.launch.dryrun --all [--resume] [--jobs N] \
      [--cell-timeout S]                                  # subprocess/cell
  python -m repro_torch.launch.dryrun --list
Results land in dryrun_results/torch/<arch>__<shape>__<mesh>.json.
"""
from __future__ import annotations

import argparse
from contextlib import nullcontext
import json
import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
OUT_DIR = ROOT / "dryrun_results" / "torch"
MESHES = {False: ("pod_16x16", (16, 16)),
          True: ("multipod_2x16x16", (2, 16, 16))}
HBM_PER_CHIP = 80 * 2**30        # one H100's HBM3, the `fits` line


def path_leaves(tree, prefix="", is_leaf=None):
    """[(path "a/b/[0]/c", leaf)] in the reference's path spelling;
    `is_leaf` stops the walk at a node (e.g. an axes tuple)."""
    if is_leaf is not None and is_leaf(tree):
        return [(prefix[:-1], tree)]
    if isinstance(tree, dict):
        items = [(f"{k}/", v) for k, v in tree.items()]
    elif isinstance(tree, (tuple, list)):
        items = [(f"[{i}]/", v) for i, v in enumerate(tree)]
    else:
        return [(prefix[:-1], tree)]
    out = []
    for k, v in items:
        out += path_leaves(v, prefix + k, is_leaf)
    return out


def model_param_counts(cfg) -> dict:
    """Exact param counts from the abstract init; active scales the MoE
    FFN by k/E (the reference's rule)."""
    from repro_torch.launch.specs import abstract_params
    shapes, _ = abstract_params(cfg)
    total = active = nonembed = 0
    moe_scale = (cfg.experts_per_token / cfg.num_experts) if cfg.is_moe \
        else 1.0
    for keys, leaf in path_leaves(shapes):
        n = leaf.numel()
        total += n
        if "embed/" in keys and "unembed" not in keys:
            continue
        nonembed += n
        if cfg.is_moe and "/ffn/" in keys and "router" not in keys:
            active += int(n * moe_scale)
        else:
            active += n
    return {"total": int(total), "nonembed": int(nonembed),
            "active_nonembed": int(active)}


def build_step(cfg, shape, opt, multi_pod: bool, dp_compress: str = "none"):
    """(step function, indices of the arguments it updates in place)."""
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.runtime.train_loop import TrainConfig, make_train_step
    if shape.kind == "train":
        tcfg = TrainConfig(num_pods=2 if multi_pod else 1,
                           dp_compress=dp_compress)
        return make_train_step(cfg, opt, tcfg), (0, 1)
    if shape.kind == "prefill":
        # VLM archs prepend `frontend_tokens` patch embeddings to the text
        max_len = shape.seq_len + cfg.frontend_tokens
        return (lambda p, b: prefill(p, cfg, b, max_len, opt)), ()
    return (lambda p, s, t, pos: decode_step(p, cfg, s, t, pos, opt)), (1,)


def mesh_name_of(multi_pod: bool, mesh_shape=None) -> str:
    if mesh_shape is None:
        return MESHES[multi_pod][0]
    if not mesh_shape:
        return "none"
    return "mesh_" + "x".join(str(n) for n in mesh_shape)


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             opt_overrides=None, dump_ops: bool = False,
             dp_compress: str = "none", mesh_shape=None,
             out_dir: Path = None) -> dict:
    """Trace one cell. `mesh_shape` replaces the production mesh (16x16,
    or 2x16x16 with `multi_pod`) by another, e.g. (2, 2) for a test;
    () traces with no mesh at all (plain fake tensors, one chip). A fake
    process group of the mesh's size is started here and ended before
    returning, so a process traces one mesh at a time."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config, get_shape
    from repro_torch.core.compute_plane import tree_leaves
    from repro_torch.device import fake_mode
    from repro_torch.launch import op_analysis
    from repro_torch.launch.mesh import (build_mesh, init_fake_distributed,
                                         shutdown_distributed)
    from repro_torch.launch.specs import (input_specs, model_options_for,
                                          shardings_for)
    from repro_torch.runtime.mesh_rules import use_mesh
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    mesh_name = mesh_name_of(multi_pod, mesh_shape)
    mesh_shape = tuple(MESHES[multi_pod][1] if mesh_shape is None
                       else mesh_shape)
    axes = {3: ("pod", "data", "model"), 2: ("data", "model")}
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "kind": shape.kind, "status": "started",
           "opt_overrides": opt_overrides or {},
           "dp_compress": dp_compress, "torch": torch.__version__}
    ok, reason = cfg.shape_supported(shape)
    if not ok:
        rec.update(status="skipped", skip_reason=reason)
        return rec
    t0 = time.time()
    chips = math.prod(mesh_shape) if mesh_shape else 1
    counter = op_analysis.OpCounter()
    if mesh_shape:
        init_fake_distributed(chips)
    try:
        mesh = build_mesh(mesh_shape, axes[len(mesh_shape)]) \
            if mesh_shape else None
        opt = model_options_for(cfg, shape, **(opt_overrides or {}))
        args, arg_axes = input_specs(cfg, shape, opt)
        args = shardings_for(args, arg_axes, mesh)
        rec["device"] = tree_leaves(args)[0].device.type
        step_fn, donate = build_step(cfg, shape, opt, multi_pod,
                                     dp_compress)
        t_specs = time.time() - t0
        donated = op_analysis.storage_bytes([args[i] for i in donate])
        try:
            with fake_mode(), implicit_replication(), \
                    use_mesh(mesh) if mesh is not None else nullcontext():
                res = op_analysis.analyze(step_fn, *args, counter=counter)
        except Exception as e:
            e.failing_op = counter.last_op
            raise
    finally:
        if mesh_shape:
            shutdown_distributed()
    t_trace = time.time() - t0 - t_specs
    if dump_ops:
        d = Path(out_dir or OUT_DIR)
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{arch}__{shape_name}__{mesh_name}.ops.json").write_text(
            json.dumps(counter.op_list(), indent=1))
    counts = model_param_counts(cfg)
    factor = 6.0 if shape.kind == "train" else 2.0
    tokens = (shape.global_batch * shape.seq_len
              if shape.kind in ("train", "prefill") else shape.global_batch)
    mem = {"argument_size_in_bytes": res["argument_bytes"],
           "output_size_in_bytes": res["output_bytes"],
           "alias_size_in_bytes": donated,
           "temp_size_in_bytes": res["peak_bytes"] - res["argument_bytes"],
           "peak_size_in_bytes": res["peak_bytes"]}
    rec.update(
        status="ok", chips=chips, specs_s=round(t_specs, 2),
        trace_s=round(t_trace, 2),
        flops=float(res["flops_per_chip"]),
        bytes_accessed=float(res["eager_op_bytes_per_chip"]),
        bound_bytes=float(res["bound_bytes"]),
        memory_analysis=mem, fits=res["peak_bytes"] <= HBM_PER_CHIP,
        reshards=sum(r["count"] for r in res["reshards"]),
        op_analysis=res, params=counts,
        model_flops=factor * counts["active_nonembed"] * tokens,
        tokens=tokens)
    return rec


def cell_list():
    from repro_torch.configs import dryrun_cells
    cells = []
    for c in dryrun_cells():
        for multi in (False, True):
            cells.append({**c, "multi_pod": multi})
    return cells


def parse_opt(text: str) -> dict:
    """"k=v,k=v" ModelOptions overrides (ints and booleans converted)."""
    overrides = {}
    for kv in filter(None, text.split(",")):
        k, v = kv.split("=")
        overrides[k] = (v if not v.replace("-", "").isdigit() else int(v))
        if v in ("True", "False"):
            overrides[k] = v == "True"
    return overrides


def _run_all(args, out_dir: Path) -> int:
    """Every cell in its own subprocess (a fresh fake world each), up to
    `args.jobs` at once; a cell still running after `args.cell_timeout`
    seconds is ended and recorded as an error."""
    env = dict(os.environ)
    src = str(ROOT / "src")
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    todo = []
    for c in cell_list():
        mesh_name = mesh_name_of(c["multi_pod"])
        out = out_dir / f"{c['arch']}__{c['shape']}__{mesh_name}.json"
        if args.resume and out.exists():
            st = json.loads(out.read_text()).get("status")
            if st in ("ok", "skipped"):
                continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", c["arch"], "--shape", c["shape"],
               "--out-dir", str(out_dir)]
        if c["multi_pod"]:
            cmd.append("--multi-pod")
        todo.append((c, mesh_name, out, cmd))
    failures, running = 0, []
    while todo or running:
        while todo and len(running) < max(1, args.jobs):
            c, mesh_name, out, cmd = todo.pop(0)
            print(f"[dryrun-all] {c['arch']} {c['shape']} {mesh_name}",
                  flush=True)
            running.append((c, mesh_name, out, time.time(),
                            subprocess.Popen(cmd, cwd=str(ROOT), env=env,
                                             stdout=subprocess.DEVNULL)))
        time.sleep(0.5)
        for item in list(running):
            c, mesh_name, out, t0, proc = item
            late = time.time() - t0 > args.cell_timeout
            if proc.poll() is None and not late:
                continue
            if proc.poll() is None:
                proc.kill()
                proc.wait()
                out.write_text(json.dumps({
                    "arch": c["arch"], "shape": c["shape"],
                    "mesh": mesh_name, "status": "error",
                    "error": f"timed out after {args.cell_timeout} s: the "
                             "trace did not finish"}, indent=2))
            failures += int(proc.returncode != 0)
            running.remove(item)
    print(f"[dryrun-all] done, {failures} failures", flush=True)
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--dump-ops", action="store_true",
                    help="write the op list (count, FLOPs, bytes by op)")
    ap.add_argument("--opt", default="",
                    help="comma k=v ModelOptions overrides")
    ap.add_argument("--dp-compress", default="none",
                    help="'int8': DaeMon-compressed pod-axis gradient sync")
    ap.add_argument("--tag", default="", help="suffix for result filename")
    ap.add_argument("--out-dir", default=str(OUT_DIR))
    ap.add_argument("--jobs", type=int, default=1,
                    help="--all: cells traced at once")
    ap.add_argument("--cell-timeout", type=float, default=7200.0,
                    help="--all: seconds before a cell is ended (error)")
    args = ap.parse_args(argv)
    out_dir = Path(args.out_dir)

    if args.list:
        for c in cell_list():
            print(c)
        return 0
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.all:
        return 1 if _run_all(args, out_dir) else 0

    mesh_name = mesh_name_of(args.multi_pod)
    tag = f"__{args.tag}" if args.tag else ""
    out = out_dir / f"{args.arch}__{args.shape}__{mesh_name}{tag}.json"
    try:
        rec = run_cell(args.arch, args.shape, args.multi_pod,
                       opt_overrides=parse_opt(args.opt),
                       dump_ops=args.dump_ops,
                       dp_compress=args.dp_compress, out_dir=out_dir)
    except Exception as e:  # record failures as first-class results
        rec = {"arch": args.arch, "shape": args.shape, "mesh": mesh_name,
               "status": "error", "error": repr(e),
               "failing_op": str(getattr(e, "failing_op", None)),
               "traceback": traceback.format_exc()}
    out.write_text(json.dumps(rec, indent=2))
    print(json.dumps({k: rec[k] for k in rec
                      if k not in ("traceback", "op_analysis")}, indent=2))
    return 0 if rec["status"] in ("ok", "skipped") else 1


if __name__ == "__main__":
    sys.exit(main())
