"""Time training epochs of the RGCN or the HGT, and their kernels, of two
checkouts of this repository in turns on one card, so that a change can be
read against host noise and the card's state.

    python -m multi_modal_gnn_tpu_torch.tools.epoch_turns --other PATH [--arch rgcn|hgt] [--rounds 5]

Starts one worker process in this checkout and one in ``PATH`` (another
checkout, e.g. a parent commit unpacked with ``git archive``).  Each builds
its own kernels, the ``scale_100k`` graph (seed 0, dense budget 0, span rows
256, ``use_pallas``) and a trainer with seeded weights (dropout 0.2): the
RGCN with the default span@256 train batch, or (``--arch hgt``) the HGT
with 4 heads of 32 on the graph's attention plans; then it runs one warm-up
epoch.  Asked for an epoch, it times one to ``torch.cuda.synchronize``;
asked for kernels, it times, each the median of 20 CUDA-event-timed calls on
seeded random inputs: for the RGCN, K1 (``segment_sum_windowed``) on every
plan a train step runs it on (the paired tier's forward and the span and
paired tiers' backward), K2f and K2b on each fused-table relation, K3 on
the span relation, K4f and K4b (dropout 0.2) of each head on the train
batch, and K5f (both heads, dropout 0.2) on the train batch laid out over the
full lab table (``lab_tile_rows: 0``, the dual-head path's batch); for the
HGT, K6, K7 and K8 on every attention group.  Then
``compute_node_state`` (the median of 5, host clock to synchronize).  Each
round asks this, other, other, this for an epoch; the kernels are asked for
in the same order once, after the rounds.  Prints the milliseconds and
their medians; both workers stop with it.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]

# runs in each checkout: only entry points that every checkout of the port has
_WORKER = """
import dataclasses, json, math, statistics, sys, time, torch
from multi_modal_gnn_tpu_torch.config import Config, GraphConfig, ModelConfig
from multi_modal_gnn_tpu_torch.data import SyntheticSpec, make_synthetic_graph
from multi_modal_gnn_tpu_torch.graph.attn_plan import ensure_attn_plans
from multi_modal_gnn_tpu_torch.models import build_model
from multi_modal_gnn_tpu_torch.training import Trainer, masker_from_config
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
arch = sys.argv[1]
config = Config(graph=GraphConfig(dense_adjacency_max_bytes=0, src_span_rows=256),
                model=ModelConfig(use_pallas=True))
graph_cpu = make_synthetic_graph(SyntheticSpec.scale_100k(seed=0), config, device="cpu")
masker = masker_from_config(config, graph_cpu)
if arch == "hgt":
    config = dataclasses.replace(config, model=dataclasses.replace(config.model, architecture="HGT", num_heads=4))
    graph = ensure_attn_plans(graph_cpu, config).to(torch.device("cuda", 0))
else:
    graph = graph_cpu.to(torch.device("cuda", 0))
trainer = Trainer(build_model(config, graph_cpu, generator=torch.Generator().manual_seed(1)),
                  graph, masker, config)
trainer.train_epoch()
trainer.epoch += 1
torch.cuda.synchronize()
print("ready", flush=True)


def median_ms(fn, reps=20):
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def rgcn_kernels(gen, d, out):
    from multi_modal_gnn_tpu_torch.ops import aggregation_tier
    from multi_modal_gnn_tpu_torch.ops import segment_kernels as sk
    from multi_modal_gnn_tpu_torch.graph.schema import mirror_edge_type
    from multi_modal_gnn_tpu_torch.ops import pairhead_kernels as pk
    for et, es in sorted(graph.edges.items()):
        mirror = graph.edges.get(mirror_edge_type(et))
        tier = aggregation_tier(es, mirror, d)
        if tier in ("paired", "windowed"):
            x = torch.randn(es.num_src, d, generator=gen).to(graph_device)
            args = (es.win_src, es.win_local, es.win_tile_map, es.num_windows)
            out["K1 forward " + "/".join(et)] = median_ms(lambda: sk.segment_sum_windowed(x, *args))
        if tier in ("span", "paired"):
            g = torch.randn(mirror.num_src, d, generator=gen).to(graph_device)
            args = (mirror.win_src, mirror.win_local, mirror.win_tile_map, mirror.num_windows)
            out["K1 backward of " + "/".join(et)] = median_ms(lambda: sk.segment_sum_windowed(g, *args))
        if tier == "fused_table":
            x = torch.randn(es.num_src, d, generator=gen).to(graph_device)
            fwd = (es.win_src, es.win_local, es.win_tile_map, es.num_windows)
            out["K2f " + "/".join(et)] = median_ms(lambda: sk.fused_table_segment_sum(x, *fwd))
            g = torch.randn(es.num_dst, d, generator=gen).to(graph_device)
            args = (es.win_src, es.win_local, es.win_tile_map, es.num_src)
            out["K2b " + "/".join(et)] = median_ms(lambda: sk.fused_table_segment_sum_bwd(g, *args))
        elif tier == "span":
            x = torch.randn(es.num_src, d, generator=gen).to(graph_device)
            args = (es.span_src, es.span_local, es.span_tile_map, es.span_base, es.num_windows,
                    es.span_rows)
            out["K3 " + "/".join(et)] = median_ms(lambda: sk.span_segment_sum(x, *args))
    batch = trainer.get_batch("train")
    plan = batch.patient_plan
    low = (batch.degrees < config.model.degree_threshold).reshape(-1, 1024)
    num_p, num_l = graph.num_nodes("patient"), graph.num_nodes("lab")
    head = [torch.randn(num_p, 64, generator=gen), torch.randn(num_l, 64, generator=gen),
            torch.randn(64, 32, generator=gen) * 0.1, torch.randn(32, generator=gen) * 0.1,
            torch.randn(32, generator=gen) * 0.1, torch.tensor([0.3])]
    head = [h.to(graph_device) for h in head]
    g_out = (torch.randn(plan.win_local.shape[0], generator=gen).to(graph_device)
             * (plan.win_local < 128)).contiguous()
    for name, mask in (("GNN", (~low).any(dim=1)), ("tabular", low.any(dim=1))):
        mask = mask.to(torch.int32)
        plan_args = (batch.lab_idx, plan.win_local, plan.win_tile_map, (1, 2), mask, plan.lab_block_map,
                     0.2, plan.lab_block_rows)
        out[f"K4f {name} head"] = median_ms(lambda: pk.pair_head_fwd(*head, *plan_args))
        out[f"K4b {name} head"] = median_ms(lambda: pk.pair_head_bwd(*head, *plan_args, plan.num_windows, g_out))
    full_config = dataclasses.replace(config, train=dataclasses.replace(config.train, extras={"lab_tile_rows": 0}))
    batch0 = masker_from_config(full_config, graph_cpu).get_split("train").to(graph_device)
    plan0 = batch0.patient_plan
    low0 = (graph.patient_lab_degree[batch0.patient_idx.long()] < config.model.degree_threshold).reshape(-1, 1024)
    masks0 = (low0.any(dim=1).to(torch.int32), (~low0).any(dim=1).to(torch.int32))
    dual = head + [torch.randn(x.shape, generator=gen).to(graph_device) for x in head]
    out["K5f both heads, full lab table"] = median_ms(lambda: pk.pair_head_dual_fwd(
        *dual, batch0.lab_idx, plan0.win_local, plan0.win_tile_map, (1, 2, 3, 4), *masks0, 0.2))


def hgt_kernels(gen, d, out):
    from multi_modal_gnn_tpu_torch.ops import attention_kernels as ak
    nh = config.model.num_heads
    for dst_t, plan in sorted(graph.attn_plans.items()):
        q = (torch.randn(plan.num_dst, d, generator=gen) / math.sqrt(d // nh)).to(graph_device)
        k, v = (torch.randn(plan.num_src_total, d, generator=gen).to(graph_device) for _ in range(2))
        dout = torch.randn(plan.num_dst, d, generator=gen).to(graph_device)
        fwd = (*plan.fwd.arrays(), plan.fwd.num_windows, nh)
        rev = (*plan.rev.arrays(), plan.rev.num_windows, nh)
        o, lse = ak.flash_attention_fwd(q, k, v, *fwd)
        n = plan.num_dst
        lse = lse[:n].contiguous()
        delta = (dout * o[:n]).reshape(n, nh, -1).sum(-1).contiguous()
        stats = (q, k, v, dout, lse, delta)
        out["K6 " + dst_t] = median_ms(lambda: ak.flash_attention_fwd(q, k, v, *fwd))
        out["K7 " + dst_t] = median_ms(lambda: ak.flash_attention_dq(*stats, *fwd))
        out["K8 " + dst_t] = median_ms(lambda: ak.flash_attention_dkv(*stats, *rev))


def kernels():
    from multi_modal_gnn_tpu_torch.serving import compute_node_state
    gen, d, out = torch.Generator().manual_seed(0), config.model.hidden_dim, {}
    (hgt_kernels if arch == "hgt" else rgcn_kernels)(gen, d, out)
    model = trainer.model
    state_ms = []
    for _ in range(6):
        t0 = time.perf_counter()
        compute_node_state(model, graph)
        torch.cuda.synchronize()
        state_ms.append((time.perf_counter() - t0) * 1e3)
    out["compute_node_state"] = statistics.median(state_ms[1:])
    model.train()
    return out


graph_device = torch.device("cuda", 0)
for line in sys.stdin:
    if line.strip() == "kernels":
        print(json.dumps(kernels()), flush=True)
        continue
    if line.strip() != "epoch":
        break
    t0 = time.perf_counter()
    trainer.train_epoch()
    torch.cuda.synchronize()
    trainer.epoch += 1
    print(f"{(time.perf_counter() - t0) * 1e3:.6f}", flush=True)
"""


def _start(root: Path, arch: str) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-c", _WORKER, arch], cwd=root, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        text=True,
    )


def _ask(worker: subprocess.Popen, what: str) -> str:
    worker.stdin.write(what + "\n")
    worker.stdin.flush()
    return worker.stdout.readline()


def main(argv: Optional[List[str]] = None) -> Dict[str, dict]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", required=True, type=Path, help="root of the other checkout")
    parser.add_argument("--arch", choices=("rgcn", "hgt"), default="rgcn")
    parser.add_argument("--rounds", type=int, default=5)
    args = parser.parse_args(argv)
    workers = {"this": _start(ROOT, args.arch), "other": _start(args.other.resolve(), args.arch)}
    try:
        for name, worker in workers.items():
            if worker.stdout.readline().strip() != "ready":
                raise RuntimeError(f"the {name} checkout's worker failed to start")
        order = ("this", "other", "other", "this")
        epochs: Dict[str, List[float]] = {"this": [], "other": []}
        for _ in range(args.rounds):
            for name in order:
                epochs[name].append(float(_ask(workers[name], "epoch")))
        kernels: Dict[str, List[dict]] = {"this": [], "other": []}
        for name in order:
            kernels[name].append(json.loads(_ask(workers[name], "kernels")))
    finally:
        for worker in workers.values():
            worker.stdin.close()
            worker.wait(timeout=120)
    for name in order[:2]:
        where = ROOT if name == "this" else args.other
        ms = epochs[name]
        print(f"{args.arch} epoch ms, {name} ({where}): {['%.4f' % x for x in ms]}  median {statistics.median(ms):.4f}")
        for kernel in kernels[name][0]:
            print(f"  {kernel}, {name}: " + ", ".join(f"{k[kernel]:.4f}" for k in kernels[name]) + " ms")
    return {"epochs": epochs, "kernels": kernels}


if __name__ == "__main__":
    main()
