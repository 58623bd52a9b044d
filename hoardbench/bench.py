"""One run of one cell: Hoard-fed training of the port, timed and checked.

:func:`load_cell` finds a cell's files by the names in ``BENCHMARK.json``:
the configuration (``configs/<config>.json``), the traffic
(``traffic/<traffic>.json``: batch, sequence length, corpus and optimizer),
the limits of its check (``limits/<workload>.json``) and a reader for each
of its metrics (``metrics/<metric>.py``).  :func:`run_cell` then builds the
pieces as ``repro_torch.launch.train.main`` builds them: the model at the
configuration's remat, the corpus striped under ``TMPDIR`` by the stripe
store, ``TokenLoader`` reading every batch as node 0, ``make_train_step``
with AdamW; the weights are the benchmark's own draw from the seed
(``weights.py``).  The launcher's loop body (``next(loader)``, the tensors
to the card, ``step_fn``, the loss read back) runs for the checked steps,
then for ``seconds`` (the window), and with ``trace`` for a few steps more
under the profiler.  After the window the program's state is freed and the
reference follows the checked steps (``check.py``).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import shutil
import statistics
import sys
import tempfile
import time
import zlib
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
#: top-level module names that the process may not hold once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: steps traced with ``--trace 1``, after the window
TRACED_STEPS = 3


def load_cell(workload: str, root: Path = ROOT) -> dict:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    w = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if w is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])

    def mine(metric):
        return workload in metric.get("workloads", [workload])

    return {
        "workload": w,
        "config": json.loads((root / entry["file"]).read_text()),
        "traffic": json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
        "limits": json.loads((HERE / "limits" / f"{workload}.json").read_text()),
        "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
        "per_layer": [m for m in bench["per_layer"] if mine(m)],
    }


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``, or for a name split by
    cells (``<metric>.<cells>``, one quantity reported under a name of its
    own where cells' spreads differ) of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file() and "." in name:
        path = HERE / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(f"hoardbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def port_config(cfg: dict):
    """The program's ``ModelConfig`` of a configuration file, held against the
    file's sizes."""
    from repro_torch.configs import ARCHS

    port = cfg["port"]
    base = ARCHS[port["arch"]]
    mc = dataclasses.replace(base, **{
        k: dataclasses.replace(getattr(base, k), **v) if isinstance(v, dict) else v
        for k, v in port["overrides"].items()})
    assumed = cfg["assumed"]
    want = {"d_model": cfg["hidden_size"], "n_heads": cfg["num_attention_heads"],
            "n_kv_heads": cfg["num_key_value_heads"], "vocab": cfg["vocab_size"],
            "n_layers": cfg["num_hidden_layers"], "norm_eps": cfg["rms_norm_eps"],
            "rope_theta": float(cfg["rope_theta"]), "tie_embeddings": cfg["tie_word_embeddings"],
            "dtype": assumed["dtype"], "remat": assumed["remat"],
            "resolved_head_dim": assumed["head_dim"]}
    if mc.moe is None:
        want["d_ff"] = cfg["intermediate_size"]
    else:
        m = mc.moe
        have = (m.n_experts, m.top_k, m.d_expert, m.n_shared, m.first_dense,
                m.first_dense_ff, m.capacity_factor)
        need = (cfg["n_routed_experts"], cfg["num_experts_per_tok"], cfg["moe_intermediate_size"],
                cfg["n_shared_experts"], cfg["first_k_dense_replace"] == 1,
                cfg["intermediate_size"], assumed["capacity_factor"])
        if have != need:
            raise ValueError(f"{port['arch']}: experts {have} where the file states {need}")
    if mc.mla is not None:
        have = (mc.mla.kv_lora_rank, mc.mla.qk_nope_dim, mc.mla.qk_rope_dim, mc.mla.v_head_dim)
        need = (cfg["kv_lora_rank"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                cfg["v_head_dim"])
        if have != need:
            raise ValueError(f"{port['arch']}: MLA {have} where the file states {need}")
    for k, v in want.items():
        if getattr(mc, k) != v:
            raise ValueError(f"{port['arch']}: {k} is {getattr(mc, k)!r}, the file states {v!r}")
    if mc.qkv_bias or mc.qk_norm or mc.sliding_window or mc.family not in ("dense", "moe"):
        raise ValueError(f"{port['arch']}: a block the reference does not hold")
    return mc


def _counters() -> dict:
    """The port's kernel wrappers' ``launches`` counts, by module."""
    from repro_torch import kernels

    out = {}
    for name in ("rmsnorm", "rmsnorm_bwd", "swiglu", "swiglu_bwd", "flash_attention",
                 "flash_attention_bwd", "decode_attention", "mlstm_scan", "mlstm_scan_bwd",
                 "ssd_scan", "ssd_scan_bwd"):
        mod = getattr(kernels, name, None)
        if mod is not None and hasattr(mod, "launches"):
            out[name] = mod.launches
    return out


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, *, t_start: float,
             device: str = "cuda", keep_grads: bool = False) -> dict:
    """One run; returns the result's fields and the check's numbers.  The
    program runs inside :func:`_drive`, so that its state is gone, and its
    memory back with the allocator, before the reference starts."""
    import torch

    from . import check

    out = _drive(cell, seed, seconds, trace, t_start=t_start, device=device,
                 keep_grads=keep_grads)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    checks = check.compare(cell, seed, torch.device(device), out.prog, out.log,
                           keep_grads=keep_grads)
    return {"run": out.run, "checks": checks, "attempted": len(out.log.losses),
            "prog": out.prog, "failed": checks["failed_steps"], "kind": out.kind}


def _drive(cell: dict, seed: int, seconds: float, trace: bool, *, t_start: float,
           device: str, keep_grads: bool):
    """The program's part of a run: set-up, the checked steps, the window and
    the traced steps; returns what the host keeps of them."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.data import TokenDatasetSpec, TokenLoader
    from repro_torch.kernels import build
    from repro_torch.launch.train import stripe_corpus
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.optimizer import init_opt_state

    from . import check, weights
    from .frozen import groups
    from .reference.model import layout, leaves

    cfg, traffic = cell["config"], cell["traffic"]
    mc = port_config(cfg)
    B, S = traffic["batch"], traffic["seq_len"]
    on_card = device == "cuda"
    dev = torch.device(device)
    model = build_model(mc, device=device)
    dtype = model.dtype
    params = weights.draw(cfg, seed, dev, dtype)
    have = [(n, tuple(i.shape)) for n, i in leaves(model.layout())]
    want = [(n, tuple(t.shape)) for n, t in leaves(params)]
    if have != want:
        raise ValueError(f"the program's parameters {have} differ from the reference's {want}")
    opt_cfg = AdamWConfig(**traffic["optimizer"])
    opt = init_opt_state(params, opt_cfg)
    data_root = tempfile.mkdtemp(prefix="hoardbench-corpus-")
    try:
        spec = TokenDatasetSpec(traffic["dataset_id"], n_sequences=traffic["n_items"],
                                seq_len=S, vocab=mc.vocab, seed=seed)
        topo, store, _ = stripe_corpus(spec, data_root, items_per_chunk=traffic["items_per_chunk"])
        loader = TokenLoader(store, spec, topo.nodes[0], batch=B)
        it = iter(loader)
        step_fn = make_train_step(model, opt_cfg)
        log = SimpleNamespace(ids=[], crc=[], losses=[], load_s=[], wait_s=[], step_s=[])
        state = {"params": params, "opt": opt}
        del params, opt

        def one_step():
            t0 = time.perf_counter()
            with record_function("hoardbench.load"):
                toks, labels = next(it)
            t1 = time.perf_counter()
            with record_function("hoardbench.to_device"):
                batch = {"tokens": torch.from_numpy(toks).long().to(dev),
                         "labels": torch.from_numpy(labels).long().to(dev)}
            with record_function("hoardbench.step"):
                state["params"], state["opt"], metrics = step_fn(state["params"], state["opt"],
                                                                 batch)
            t2 = time.perf_counter()
            with record_function("hoardbench.loss_read"):
                loss = float(metrics["loss"])      # waits for the step, as the launcher does
            log.wait_s.append(time.perf_counter() - t2)
            log.step_s.append(time.perf_counter() - t0)
            log.ids.append(loader.last_ids.tolist())
            log.crc.append(zlib.crc32(toks.tobytes()))
            log.losses.append(loss)
            log.load_s.append(t1 - t0)

        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        prog = check.ProgramReadings()
        b1 = opt_cfg.b1
        keep_grads = keep_grads or cell["limits"].get("grad_diff") is not None
        for i in range(traffic["checked_steps"]):
            one_step()
            if i == 0:
                prog.grad = {n: float(torch.linalg.vector_norm(m, dtype=torch.float64)) / (1 - b1)
                             for n, m in leaves(state["opt"]["mu"])}
                if keep_grads:
                    prog.grad_tensors = {n: m.to("cpu", torch.float32, copy=True).div_(1 - b1)
                                         for n, m in leaves(state["opt"]["mu"])}
        prog.losses = list(log.losses)
        specs = dict(leaves(layout(cfg)))
        prog.change = {}
        now = state["opt"]["master"] if "master" in state["opt"] else state["params"]
        for n, t in leaves(now):
            init = weights.draw_leaf(specs[n], seed, n, dev, dtype)
            prog.change[n] = check.diff_norm(t, init)
            del init

        n_warm = len(log.losses)
        t_w0 = time.perf_counter()
        setup_s = t_w0 - t_start
        while time.perf_counter() - t_w0 < seconds:
            one_step()
        window_s = time.perf_counter() - t_w0
        n_window = len(log.losses) - n_warm
        _print_steps(log, n_warm, n_window)

        traced = None
        if trace:
            moe = mc.moe is not None
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         record_shapes=moe) as prof:
                c0 = _counters()
                tp0 = time.perf_counter()
                for _ in range(TRACED_STEPS):
                    one_step()
                if on_card:
                    torch.cuda.synchronize()
                traced_s = time.perf_counter() - tp0
                c1 = _counters()
            from . import trace as trace_mod

            experts = (mc.moe.n_experts, mc.moe.d_expert, mc.d_model) if moe else None
            traced = trace_mod.reduce(prof, TRACED_STEPS, groups.port_kernels(build.CSRC),
                                      experts)
            traced["window_s"] = traced_s
            traced["calls"] = {k: (c1[k] - c0[k]) / TRACED_STEPS for k in c1}

        peak = torch.cuda.max_memory_allocated() if on_card else 0
        kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    finally:
        shutil.rmtree(data_root, ignore_errors=True)

    window = SimpleNamespace(steps=n_window, seconds=window_s, tokens=n_window * B * S,
                             load_s=log.load_s[n_warm:n_warm + n_window])
    run = SimpleNamespace(config=cfg, traffic=traffic, setup_s=setup_s, window=window,
                          peak_bytes=peak, trace=traced)
    return SimpleNamespace(run=run, prog=prog, log=log, kind=kind)


def _print_steps(log, start: int, n: int) -> None:
    """The window's step times on standard error: host seconds a step, and of
    them the wait for the card at the loss's read (near 0 where the host
    paces the step)."""
    if not n:
        return
    q = lambda xs: [round(x, 4) for x in (min(xs), statistics.median(xs), max(xs))]  # noqa: E731
    part = slice(start, start + n)
    print(f"[window] {n} steps; step s min/median/max {q(log.step_s[part])}; waiting for the "
          f"card {q(log.wait_s[part])}; loading {q(log.load_s[part])}", file=sys.stderr)


def result(cell: dict, out: dict, trace: bool) -> dict:
    """The result's line: the cell's metrics by their readers, the device, the checks."""
    run = out["run"]
    metrics = {}
    for m in cell["per_layer" if trace else "end_to_end"]:
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = out["checks"]
    res = {"correct": checks["correct"], "attempted": out["attempted"], "failed": out["failed"],
           "metrics": metrics,
           "device": {"platform": "gpu", "kind": out["kind"], "count": 1,
                      "memory_peak_bytes": run.peak_bytes}}
    if trace:
        res["device"]["busy_s"] = run.trace["busy_s"]
        res["device"]["window_s"] = run.trace["window_s"]
        res["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    res["checks"] = checks["numbers"]
    return res
