"""PyTorch / CUDA port of ``multi_modal_gnn_tpu`` for one NVIDIA H100.

The JAX package next to this one is the reference; this package imports
``torch``, ``numpy`` and the standard library only.  It keeps the JAX
package's module layout so each module's counterpart is easy to find:

* :mod:`.config` — the ``model`` / ``graph`` config sections as dataclasses;
* :mod:`.graph` — edge-set plans (windowed, span, dense), the HGT
  attention plans, node numbering, graph assembly and the ``graph.npz``
  reader;
* :mod:`.data.synthetic` — the ``flat`` synthetic cohort as COO arrays;
* :mod:`.ops` — neighbor aggregation with its tier dispatch, the HGT
  flash attention, and the hand-written CUDA kernels (``csrc/segment.cu``,
  ``csrc/pairhead.cu``, ``csrc/attention.cu``);
* :mod:`.models` — ``HeteroRGCN`` and ``HeteroGT`` with their heads, the
  factory and the flax weight bridge;
* :mod:`.training` — the masker, losses, schedulers and the full-batch
  trainer;
* :mod:`.serving` — cached node state and per-request pair heads.
"""

__version__ = "0.1.0"
