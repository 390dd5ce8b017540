"""``python -m multi_modal_gnn_tpu_torch``: the pipeline command line
(:func:`multi_modal_gnn_tpu_torch.pipeline.main`), from any directory where
the package imports."""

import sys

from multi_modal_gnn_tpu_torch.pipeline import main

if __name__ == "__main__":
    sys.exit(main())
