# float32 contractions ask for full float32 products: on GPUs XLA may
# otherwise run them in TF32, which keeps about three decimal digits.
PRECISION = "highest"

from .cavi import cavi_step, elog_tables, phi_segment_sums, run_cavi_block  # noqa: F401
from .metrics import llk_rmse_sums, predict_pairs, sum_pairs_prediction  # noqa: F401
