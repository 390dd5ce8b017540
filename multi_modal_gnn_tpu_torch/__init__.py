"""PyTorch / CUDA port of ``multi_modal_gnn_tpu`` for one NVIDIA H100.

The JAX package next to this one is the reference; this package imports
``torch``, ``numpy`` and the standard library only.  It keeps the JAX
package's module layout so each module's counterpart is easy to find:

* :mod:`.config` — every config section as dataclasses, read from
  ``conf/*.yaml`` by a YAML subset reader (:mod:`.utils.yaml_subset`);
* :mod:`.data` — the flat and eICU-phenomenology synthetic cohorts, as COO
  arrays or as the preprocess stage's tables, and the preprocess stage;
* :mod:`.graph` — edge-set plans (windowed, span, dense), the HGT
  attention plans, node indexers and numbering, the graph build from
  tables, validation and the ``graph.npz`` artifact;
* :mod:`.ops` — neighbor aggregation with its tier dispatch, the HGT
  flash attention, and the hand-written CUDA kernels (``csrc/segment.cu``,
  ``csrc/pairhead.cu``, ``csrc/attention.cu``);
* :mod:`.models` — ``HeteroRGCN`` and ``HeteroGT`` with their heads, the
  factory and the flax weight bridge;
* :mod:`.training` — the masker, losses, schedulers and the full-batch
  trainer;
* :mod:`.evaluation`, :mod:`.audit`, :mod:`.inference` — metrics,
  baselines and conformal intervals, the leakage audit, per-patient
  reports;
* :mod:`.serving` — cached node state and per-request pair heads;
* :mod:`.pipeline` — the command line, ``python -m
  multi_modal_gnn_tpu_torch.pipeline``.
"""

__version__ = "0.1.0"
