"""Graph-structure visualization (``multi_modal_gnn_tpu/viz/graph_viz.py``),
under ``<output>/graph_visualizations/``:

* graph_overview — node / edge count panels, degree histogram, stats text;
* patient_<id>_subgraph — radial ego network of a patient with typed
  colors and lab-value labels;
* network_sample — spring-layout plot of a sampled subgraph (networkx).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from multi_modal_gnn_tpu_torch.graph.schema import (
    DIAGNOSIS,
    LAB,
    MEDICATION,
    PATIENT,
    PATIENT_DIAGNOSIS,
    PATIENT_LAB,
    PATIENT_MEDICATION,
)
from multi_modal_gnn_tpu_torch.graph.stats import compute_graph_statistics
from multi_modal_gnn_tpu_torch.viz import Figures

_TYPE_COLORS = {
    PATIENT: "#4878a8",
    LAB: "#d1615d",
    DIAGNOSIS: "#6aa56e",
    MEDICATION: "#e49444",
}


def _host_edges(bundle, et):
    """``(src, dst, val)`` of a relation's valid edges: the bundle's host
    copy when it holds the relation (after a load it holds only some), else
    the graph's masked arrays."""
    if bundle.host_edges and et in bundle.host_edges:
        return bundle.host_edges[et]
    es = bundle.graph.edges[et]
    mask = es.mask.cpu().numpy() > 0
    val = es.val.cpu().numpy()[mask] if es.val is not None else None
    return es.src.cpu().numpy()[mask], es.dst.cpu().numpy()[mask], val


def patient_edges(bundle) -> Dict:
    """:func:`_host_edges` of the patient relations the graph has, read
    once.  A disabled modality is left out of the figures (JAX's step 6
    raises ``KeyError`` on it)."""
    return {
        et: _host_edges(bundle, et)
        for et in (PATIENT_LAB, PATIENT_DIAGNOSIS, PATIENT_MEDICATION)
        if et in bundle.graph.edges
    }


def extract_patient_subgraph(
    bundle, patient_idx: int, max_neighbors: int = 12, edges: Optional[Dict] = None
) -> Dict[str, list]:
    """A patient's direct neighbors per modality, capped for readability;
    ``edges``: :func:`patient_edges`, read here when not given."""
    edges = edges if edges is not None else patient_edges(bundle)
    out: Dict[str, list] = {"labs": [], "diagnoses": [], "medications": []}
    meta = bundle.meta
    for key, et, names in (
        ("labs", PATIENT_LAB, meta.lab_names),
        ("diagnoses", PATIENT_DIAGNOSIS, None),
        ("medications", PATIENT_MEDICATION, None),
    ):
        if et not in edges:
            continue
        src, dst, val = edges[et]
        sel = np.where(src == patient_idx)[0][:max_neighbors]
        for pos in sel:
            idx = int(dst[pos])
            if names is not None:
                label = names.get(idx, f"{et[2]}_{idx}")
            elif et[2] in meta.indexers:
                label = str(meta.indexers[et[2]].id_of(idx))
            else:
                label = f"{et[2]}_{idx}"
            out[key].append(
                {"index": idx, "label": label, "value": float(val[pos]) if val is not None else None}
            )
    return out


def plot_patient_subgraph(bundle, patient_idx: int, out: Path, figures: Figures,
                          edges: Optional[Dict] = None) -> None:
    """Radial ego plot: the patient in the center, typed neighbors on rings."""
    sub = extract_patient_subgraph(bundle, patient_idx, edges=edges)

    def plot(plt):
        fig, ax = plt.subplots(figsize=(8, 8))
        ax.scatter([0], [0], s=600, color=_TYPE_COLORS[PATIENT], zorder=3)
        ax.annotate("patient", (0, 0), ha="center", va="center", fontsize=8, color="white")
        groups = [(sub["labs"], LAB, 1.0), (sub["diagnoses"], DIAGNOSIS, 1.8),
                  (sub["medications"], MEDICATION, 2.6)]
        for items, ntype, radius in groups:
            n = len(items)
            for i, item in enumerate(items):
                theta = 2 * np.pi * i / max(n, 1) + 0.15 * radius
                x, y = radius * np.cos(theta), radius * np.sin(theta)
                ax.plot([0, x], [0, y], color="lightgray", lw=0.8, zorder=1)
                ax.scatter([x], [y], s=250, color=_TYPE_COLORS[ntype], zorder=3)
                label = item["label"][:16]
                if item["value"] is not None:
                    label += f"\n{item['value']:.2f}"
                ax.annotate(label, (x, y), ha="center", va="center", fontsize=6)
        handles = [
            plt.Line2D([0], [0], marker="o", ls="", color=c, label=t)
            for t, c in _TYPE_COLORS.items()
        ]
        ax.legend(handles=handles, loc="upper right")
        ax.set_axis_off()
        ax.set_title(f"Patient node {patient_idx} neighborhood")
        return fig

    figures.draw(out / f"patient_{patient_idx}_subgraph.png", plot)


def plot_graph_overview(bundle, out: Path, figures: Figures) -> None:
    """Counts + degree histogram + stats text."""
    stats = compute_graph_statistics(bundle.graph)
    degree = bundle.graph.patient_lab_degree.cpu().numpy()

    def plot(plt):
        fig, axes = plt.subplots(2, 2, figsize=(11, 8))
        nodes = stats["num_nodes"]
        axes[0, 0].bar(nodes.keys(), nodes.values(),
                       color=[_TYPE_COLORS.get(k, "gray") for k in nodes])
        axes[0, 0].set_title("Nodes per type")
        fwd_edges = {k.split("__")[1]: v for k, v in stats["num_edges"].items() if "rev_" not in k}
        axes[0, 1].bar(fwd_edges.keys(), fwd_edges.values(), color="#4878a8")
        axes[0, 1].set_title("Edges per relation (forward)")
        axes[0, 1].tick_params(axis="x", rotation=20)
        axes[1, 0].hist(degree[degree > 0], bins=30, color="#6aa56e", edgecolor="white")
        axes[1, 0].set_title("Patient lab-degree")
        text = [f"patient-lab density: {stats.get('patient_lab_density', 0):.2%}"]
        for rel, d in stats.get("patient_degree", {}).items():
            text.append(f"{rel.split('__')[1]}: mean {d['mean']:.1f} max {d['max']}")
        axes[1, 1].text(0.05, 0.95, "\n".join(text), va="top", family="monospace", fontsize=9)
        axes[1, 1].set_axis_off()
        axes[1, 1].set_title("Statistics")
        return fig

    figures.draw(out / "graph_overview.png", plot)


def network_sample(bundle, num_patients: int = 25, edges: Optional[Dict] = None):
    """JAX's sampled patients (seed 0 among the patients with labs) and
    their edges ``(relation, src, dst)`` in the graph's order."""
    edges = edges if edges is not None else patient_edges(bundle)
    degree = bundle.graph.patient_lab_degree.cpu().numpy()
    candidates = np.where(degree > 0)[0]
    rng = np.random.default_rng(0)
    sample = rng.choice(candidates, size=min(num_patients, len(candidates)), replace=False)
    picked = []
    for et, (src, dst, _) in edges.items():
        keep = np.isin(src, sample)
        picked.append((et, src[keep], dst[keep]))
    return sample, picked


def plot_network_sample(bundle, out: Path, figures: Figures, num_patients: int = 25,
                        edges: Optional[Dict] = None) -> None:
    """Spring-layout plot of a sampled patient-induced subgraph (networkx)."""
    sample, edges = network_sample(bundle, num_patients, edges)

    def plot(plt):
        import networkx as nx

        g = nx.Graph()
        for et, src, dst in edges:
            for s, d in zip(src, dst):
                g.add_node(f"p{s}", ntype=PATIENT)
                g.add_node(f"{et[2][:3]}{d}", ntype=et[2])
                g.add_edge(f"p{s}", f"{et[2][:3]}{d}")
        pos = nx.spring_layout(g, seed=0, k=0.25)
        fig, ax = plt.subplots(figsize=(9, 9))
        for ntype, color in _TYPE_COLORS.items():
            nodes = [n for n, d in g.nodes(data=True) if d["ntype"] == ntype]
            nx.draw_networkx_nodes(g, pos, nodelist=nodes, node_color=color,
                                   node_size=30, ax=ax, label=ntype)
        nx.draw_networkx_edges(g, pos, alpha=0.15, ax=ax)
        ax.legend()
        ax.set_axis_off()
        ax.set_title(f"Sampled network ({len(set(sample.tolist()))} patients, {g.number_of_nodes()} nodes)")
        return fig

    figures.draw(out / "network_sample.png", plot, needs=("networkx",))


def example_patients(config, bundle) -> List[int]:
    """The lowest-, median- and highest-degree patients, then random
    patients with labs (seed 1) up to ``num_example_subgraphs``."""
    degree = bundle.graph.patient_lab_degree.cpu().numpy()
    observed = np.where(degree > 0)[0]
    order = observed[np.argsort(degree[observed])]
    patient_ids = [int(order[0]), int(order[len(order) // 2]), int(order[-1])]
    n_extra = max(config.visualization.num_example_subgraphs - len(patient_ids), 0)
    rng = np.random.default_rng(1)
    extras = [int(x) for x in rng.choice(observed, size=min(n_extra, len(observed)), replace=False)]
    patient_ids.extend(x for x in extras if x not in patient_ids)
    return patient_ids


def visualize_graph_structure(
    config, bundle, output_dir="outputs", patient_ids: Optional[List[int]] = None,
    figures: Optional[Figures] = None,
) -> Path:
    """The graph family (JAX ``visualize_graph_structure``): the overview,
    low / median / high-degree patient subgraphs, the network sample."""
    out = Path(output_dir) / "graph_visualizations"
    figures = figures if figures is not None else Figures()
    plot_graph_overview(bundle, out, figures)
    edges = patient_edges(bundle)
    if patient_ids is None:
        patient_ids = example_patients(config, bundle)
    if config.visualization.generate_subgraphs:
        for pid in patient_ids:
            plot_patient_subgraph(bundle, pid, out, figures, edges)
    plot_network_sample(bundle, out, figures, edges=edges)
    return out
