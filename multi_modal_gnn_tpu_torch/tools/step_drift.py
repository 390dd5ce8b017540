"""How far one bfloat16 value-context train step's gradients drift on the
card: from run to run of the card's step on the same weights, and from the
CPU plain step, per parameter, beside bfloat16's own effect on them.

    python -m multi_modal_gnn_tpu_torch.tools.step_drift [--runs 20]

On the ``scale_100k`` graph (``chip_smoke.py`` phase 3's config: dense
budget 0, span rows 256, ``use_pallas``, hidden 128) with phase 23's
channels (value context, the context bilinear source of rank 8, dropout 0),
``--runs`` fresh RGCNs on the same seeded weights (seed 0) each take one
Adam step on the train split's epoch-0 supervision mask on the card in
bfloat16; then the CPU plain step takes it in bfloat16 and in float32.  Per
parameter it prints the gradient's norm on the CPU in bfloat16, each card
run's relative distance from it, the largest relative distance between two
card runs, and ``||bf16 - f32|| / ||bf16||`` on the CPU.  The kernels'
atomics change the order of sums from run to run, so card runs differ among
themselves; a parameter whose card runs reach the CPU step's distance among
themselves holds only rounding noise at this size.  One JSON line at the
end (per parameter: ``norm``, ``card_vs_cpu``, ``card_spread``,
``bf16_effect``; the card).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, List, Optional, Sequence

import torch

from multi_modal_gnn_tpu_torch.utils.device import disable_tf32, gpu_identity, require_cuda

RANK = 8


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """``||a - b|| / ||b||`` in float64 (0 where ``b`` is 0)."""
    a, b = a.double().cpu(), b.double().cpu()
    norm = float(torch.linalg.vector_norm(b))
    return float(torch.linalg.vector_norm(a - b)) / norm if norm > 0 else 0.0


def one_step(config, graph_cpu, graph, masker, sup, device: str) -> Dict[str, torch.Tensor]:
    """One train step of a fresh model (seed 0); its gradients on the CPU."""
    from multi_modal_gnn_tpu_torch.models import build_model
    from multi_modal_gnn_tpu_torch.training import Trainer

    model = build_model(config, graph_cpu, device=device, generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, graph, masker, config, device=device)
    trainer.train_step(trainer.get_batch("train"), sup.to(device), 0)
    return {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}


def drift_table(card: List[Dict[str, torch.Tensor]], cpu: Dict[str, torch.Tensor],
                cpu_f32: Dict[str, torch.Tensor]) -> Dict[str, Dict]:
    """Per parameter: the CPU bf16 gradient's norm, each card run's distance
    from it, the card runs' largest distance among themselves, and the CPU's
    bf16 - f32 effect, each relative to the CPU bf16 gradient's norm."""
    out = {}
    for name, ref in cpu.items():
        norm = float(ref.double().norm())
        spread = max((float((a[name].double() - b[name].double()).norm()) / norm if norm > 0 else 0.0)
                     for i, a in enumerate(card) for b in card[i + 1:])
        out[name] = {
            "norm": norm,
            "card_vs_cpu": [rel(run[name], ref) for run in card],
            "card_spread": spread,
            "bf16_effect": rel(cpu_f32[name], ref),
        }
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--runs", type=int, default=20, help="card steps from the same weights")
    args = parser.parse_args(argv)

    from multi_modal_gnn_tpu_torch.config import Config, GraphConfig, ModelConfig
    from multi_modal_gnn_tpu_torch.data import SyntheticSpec, make_synthetic_graph
    from multi_modal_gnn_tpu_torch.training import masker_from_config

    require_cuda()
    disable_tf32()
    base = Config(
        graph=GraphConfig(dense_adjacency_max_bytes=0, src_span_rows=256),
        model=ModelConfig(use_pallas=True),
    )
    graph_cpu = make_synthetic_graph(SyntheticSpec.scale_100k(seed=0), base, device="cpu")
    graph = graph_cpu.to("cuda")
    masker = masker_from_config(base, graph_cpu)
    sup = masker.supervision_mask(0, masker.get_split("train"))

    def channels(dtype: str):
        mc = base.model
        head = dataclasses.replace(mc.edge_head, extras={"bilinear_rank": RANK, "bilinear_source": "context"})
        return dataclasses.replace(base, model=dataclasses.replace(
            mc, dropout=0.0, compute_dtype=dtype, extras={**mc.extras, "value_context": True}, edge_head=head))

    bf16 = channels("bfloat16")
    card = [one_step(bf16, graph_cpu, graph, masker, sup, "cuda") for _ in range(args.runs)]
    cpu = one_step(bf16, graph_cpu, graph_cpu, masker, sup, "cpu")
    cpu_f32 = one_step(channels("float32"), graph_cpu, graph_cpu, masker, sup, "cpu")
    table = drift_table(card, cpu, cpu_f32)
    for name, row in sorted(table.items(), key=lambda kv: -max(kv[1]["card_vs_cpu"])):
        runs = row["card_vs_cpu"]
        print(f"{name}: ||cpu|| {row['norm']:.3e}  card vs cpu min {min(runs):.3e} max {max(runs):.3e}  "
              f"card spread {row['card_spread']:.3e}  bf16 effect {row['bf16_effect']:.3e}", flush=True)
    result = {"runs": args.runs, "rank": RANK, "params": table, "device_identity": gpu_identity()}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
