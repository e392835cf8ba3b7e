"""Pose NMS, capacity-1 form.

Counterpart of `betapose_tpu/ops/pose_nms.py:271` (`pose_nms_single`, the
reference `pPose_nms.py` with one candidate per frame): NMS picks the only
candidate and the merge cluster is itself, so the merged pose is the pose
and the merged score the score.  The multi-candidate host loop (`pose_nms`)
and the fixed-trip device loop belong to ROADMAP slice 2.

Eval-path constants (`pPose_nms.py:12-20`): scoreThreds = 0.3; output
keypoints carry the reference's -0.3 offset; proposal_score =
mean(scores) + bbox_score + 1.25 * max(scores).
"""

from __future__ import annotations

import torch

SCORE_THRESH = 0.3
KP_OFFSET = -0.3


def pose_nms_single(bbox_score, pose_pred, pose_score):
    """Batched single-candidate pose NMS.

    bbox_score [B]; pose_pred [B,K,2]; pose_score [B,K,1].  Returns
    (keypoints [B,K,2], kp_score [B,K], proposal_score [B], valid [B]).
    A zero keypoint score is floored to 1e-5, as the reference does; `valid`
    carries the scoreThreds filter for the caller to mask with."""
    score = torch.where(pose_score == 0, 1e-5, pose_score)[..., 0]
    keypoints = pose_pred + KP_OFFSET
    max_score = score.amax(dim=1)
    valid = max_score >= SCORE_THRESH
    proposal = score.mean(dim=1) + bbox_score + 1.25 * max_score
    return keypoints, score, proposal, valid
