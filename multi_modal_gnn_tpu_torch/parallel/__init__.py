"""1-D data parallelism over ``torch.distributed`` ranks
(``multi_modal_gnn_tpu/parallel/``, ``train.extras.parallel: dp | data``).

The layout is JAX's (``parallel/__init__.py:1-15``):

* every relation's padded, dst-sorted edge arrays are cut into contiguous
  equal chunks, one a rank (:mod:`.sharding`);
* node tables and parameters are replicated;
* each rank sums its chunk per destination (K1 over its shard plan, or the
  segment path) and one all-reduce a relation a layer combines the sums
  (:mod:`.collectives`);
* the supervised batch is cut the same way, and the loss's numerator and
  denominator are all-reduced.

The 2-D layout (``train.extras.parallel: 2d | dp2d``) also cuts the
patient table row-wise over a model axis (:mod:`.dp2d`).

Modules: :mod:`.mesh` (the process group, :class:`~.mesh.DataAxis`, the
2-D mesh's axes :func:`~.mesh.init_2d_axes`), :mod:`.collectives`,
:mod:`.sharding`, :mod:`.dp` (:class:`~.dp.DataParallelTrainer`, full
batch), :mod:`.minibatch_dp` (:class:`~.minibatch_dp.MiniBatchDPTrainer`,
Cluster-GCN), :mod:`.dp2d` (:class:`~.dp2d.TwoDTrainer`), :mod:`.launch`
(N ranks in fresh processes).  The package imports only :mod:`.mesh`: the
trainers import the training package, whose losses import the
collectives.  ``gspmd`` (XLA's partitioner placing the collectives) is not
ported (ROADMAP.md queue 1 item 8c).
"""

from multi_modal_gnn_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    DataAxis,
    Mesh2D,
    init_2d_axes,
    init_axis,
)
