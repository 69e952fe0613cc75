"""Bundle adjustment: Lie maps, pose-graph optimization, dense BA with
Schur-complement reduction and its edge split over processes."""
from dro_sfm_torch.ba.dense_ba import (
    BAProblem,
    make_sharded_accumulate,
    optimize_dense_ba,
)
from dro_sfm_torch.ba.lie import se3_exp, se3_log, so3_exp, so3_log
from dro_sfm_torch.ba.pose_graph import optimize_pose_graph, total_edge_error
