"""Parametric pose NMS (pPose-NMS) and score-weighted pose merging.

Counterpart of `betapose_tpu/ops/pose_nms.py` (reference
`pPose_nms.py:24-281`), in three forms:

- `pose_nms`: the reference's clustering loop in float64 numpy, a copy of
  the JAX package's (the multi-candidate path's host mode,
  `host_pose_nms=True`);
- `pose_nms_device`: the same loop as a fixed-trip torch loop over the N
  candidates of each frame, batched over frames (the multi-candidate
  path's default mode, no host sync);
- `pose_nms_single`: the capacity-1 form, where NMS picks the only
  candidate and the merge cluster is itself.

Eval-path constants (`pPose_nms.py:12-20`; the canonical values per
SURVEY.md 2.10):
  delta1 = 1, mu = 1.7, delta2 = 2.65, gamma = 22.48,
  scoreThreds = 0.3, matchThreds = 5, areaThres = 0, alpha = 0.1.
Output keypoints carry the reference's -0.3 offset; proposal_score =
mean(scores) + bbox_score + 1.25 * max(scores).
"""

from __future__ import annotations

import numpy as np
import torch

DELTA1 = 1.0
MU = 1.7
DELTA2 = 2.65
GAMMA = 22.48
SCORE_THRESH = 0.3
MATCH_THRESH = 5
AREA_THRESH = 0.0
ALPHA = 0.1
KP_OFFSET = -0.3


def _parametric_distance(pick, preds, scores, ref_dist, delta2=DELTA2):
    """`get_parametric_distance` (`pPose_nms.py:244-268`).  delta2 defaults
    to the eval-path constant 2.65; the trainer-side variant
    (`train_KPD/src/predict/p_poseNMS.py`) uses 1.3 — pass it through
    `pose_nms(..., delta2=1.3)` for that behavior."""
    pick_preds = preds[pick]            # [K,2]
    pred_scores = scores[pick][:, 0]    # [K]
    dist = np.sqrt(np.sum((pick_preds[None] - preds) ** 2, axis=2))  # [n,K]
    mask = dist <= 1.0
    kp_num = preds.shape[1]
    score_dists = np.zeros((preds.shape[0], kp_num))
    sc = scores[:, :, 0]                # [n,K]
    ps = np.broadcast_to(pred_scores[None, :], sc.shape)
    score_dists[mask] = (np.tanh(ps[mask] / DELTA1)
                         * np.tanh(sc[mask] / DELTA1))
    point_dist = np.exp(-dist / delta2)
    return score_dists.sum(axis=1) + MU * point_dist.sum(axis=1)


def _pck_match(pick_pred, preds, ref_dist):
    """`PCK_match` (`pPose_nms.py:271-281`).  A degenerate zero-size box
    gives ref == 0; numpy's inf/nan comparison semantics then match the
    reference's behavior exactly — just don't warn about it."""
    dist = np.sqrt(np.sum((pick_pred[None] - preds) ** 2, axis=2))
    ref = min(ref_dist, 7)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.sum(dist / ref <= 1, axis=1)


def _merge_fast(ref_pose, cluster_preds, cluster_scores, ref_dist):
    """`p_merge_fast` (`pPose_nms.py:204-241`): score-weighted merge of all
    cluster poses whose per-keypoint distance to the reference pose is within
    min(ref_dist, 15)."""
    dist = np.sqrt(np.sum((ref_pose[None] - cluster_preds) ** 2, axis=2))
    ref = min(ref_dist, 15)
    mask = dist <= ref                                   # [m,K]
    masked_scores = cluster_scores * mask[..., None]     # [m,K,1]
    denom = masked_scores.sum(axis=0)                    # [K,1]
    denom = np.where(denom == 0, 1e-12, denom)
    normed = masked_scores / denom
    final_pose = (cluster_preds * normed).sum(axis=0)    # [K,2]
    final_score = (masked_scores * normed).sum(axis=0)[:, 0]  # [K]
    return final_pose, final_score


def pose_nms(bboxes, bbox_scores, pose_preds, pose_scores, delta2=DELTA2):
    """Parametric pose NMS (`pPose_nms.py:24-122`).

    bboxes (n,4) xyxy; bbox_scores (n,); pose_preds (n,K,2);
    pose_scores (n,K,1).  Returns a list of result dicts with keys
    'bbox', 'keypoints', 'kp_score', 'proposal_score'."""
    bboxes = np.asarray(bboxes, np.float64)
    bbox_scores = np.asarray(bbox_scores, np.float64).reshape(-1)
    pose_preds = np.asarray(pose_preds, np.float64)
    pose_scores = np.asarray(pose_scores, np.float64)
    if pose_scores.ndim == 2:
        pose_scores = pose_scores[..., None]
    pose_scores = pose_scores.copy()
    pose_scores[pose_scores == 0] = 1e-5

    n = bboxes.shape[0]
    widths = bboxes[:, 2] - bboxes[:, 0]
    heights = bboxes[:, 3] - bboxes[:, 1]
    ref_dists = ALPHA * np.maximum(widths, heights)

    ori_preds = pose_preds.copy()
    ori_scores = pose_scores.copy()
    ori_bbox_scores = bbox_scores.copy()

    human_scores = pose_scores.mean(axis=1)[:, 0]
    human_ids = np.arange(n)
    preds, scores, bscores = pose_preds, pose_scores, bbox_scores

    pick, merge_ids = [], []
    while human_scores.shape[0] != 0:
        pick_id = int(np.argmax(human_scores))
        pick.append(human_ids[pick_id])
        ref_dist = ref_dists[human_ids[pick_id]]
        simi = _parametric_distance(pick_id, preds, scores, ref_dist, delta2)
        n_match = _pck_match(preds[pick_id], preds, ref_dist)
        delete_ids = np.arange(human_scores.shape[0])[
            (simi > GAMMA) | (n_match >= MATCH_THRESH)]
        if delete_ids.size == 0:
            delete_ids = np.array([pick_id])
        merge_ids.append(human_ids[delete_ids])
        preds = np.delete(preds, delete_ids, axis=0)
        scores = np.delete(scores, delete_ids, axis=0)
        human_ids = np.delete(human_ids, delete_ids)
        human_scores = np.delete(human_scores, delete_ids, axis=0)
        bscores = np.delete(bscores, delete_ids, axis=0)

    final_result = []
    for j, p in enumerate(pick):
        scores_pick = ori_scores[p]
        if scores_pick[:, 0].max() < SCORE_THRESH:
            continue
        merge_id = merge_ids[j]
        merge_pose, merge_score = _merge_fast(
            ori_preds[p], ori_preds[merge_id], ori_scores[merge_id],
            ref_dists[p])
        max_score = merge_score.max()
        if max_score < SCORE_THRESH:
            continue
        xmax, xmin = merge_pose[:, 0].max(), merge_pose[:, 0].min()
        ymax, ymin = merge_pose[:, 1].max(), merge_pose[:, 1].min()
        if 1.5 ** 2 * (xmax - xmin) * (ymax - ymin) < AREA_THRESH:
            continue
        final_result.append({
            # reference appends bboxes[0] (sic — first box, pPose_nms.py:115)
            "bbox": bboxes[0],
            "keypoints": merge_pose + KP_OFFSET,
            "kp_score": merge_score[:, None],
            "proposal_score": float(
                merge_score.mean() + ori_bbox_scores[p]
                + 1.25 * merge_score.max()),
            # extensions beyond the reference dict (additive): the PICKED
            # candidate's own box/score, so callers can attribute outputs
            # to the detection that actually won the cluster
            "pick_bbox": bboxes[p],
            "bbox_score": float(ori_bbox_scores[p]),
        })
    return final_result


def pose_nms_device(bboxes, bbox_scores, preds, scores, valid,
                    delta2=DELTA2, extra=None):
    """Fixed-capacity pPose-NMS on the device, batched over frames,
    returning each frame's best surviving proposal.

    The reference clustering loop (`pPose_nms.py:24-122`: pick the max,
    delete by parametric similarity or PCK match, score-weighted merge
    `p_merge_fast:204-241`) as exactly N trips: each trip deletes at least
    the pick, so N trips exhaust the candidates.  Similarity, match and
    merge tensors are precomputed [B,N,N,K] elementwise ops; the trips only
    update masks, with no host sync.

    One guard beyond the reference: the pick is always in its own
    delete/merge set.  With K >= 5 keypoints the PCK self-match already
    guarantees it; for K < 5 the reference would loop forever.

    bboxes [B,N,4] xyxy; bbox_scores [B,N]; preds [B,N,K,2]; scores
    [B,N,K]; valid [B,N] bool (padded or below-threshold slots).  Returns
    (keypoints [B,K,2] with the -0.3 offset, kp_score [B,K], proposal_score
    [B], pick_bbox [B,4], pick_bbox_score [B], valid_out [B]) for each
    frame's surviving proposal with the highest proposal_score.  A frame
    with no survivor returns candidate 0's merge with valid_out False
    (`argmax` over all -inf takes the first index, as `jnp.argmax` does).

    extra: optional [B,N,K] per-keypoint statistic (heatmap concentration)
    carried through the same score-weighted merge as the coordinates; the
    winner's merged [B,K] row is appended to the returned tuple."""
    b, n, k = scores.shape
    f32 = torch.float32
    bboxes = bboxes.to(f32)
    bbox_scores = bbox_scores.to(f32).reshape(b, n)
    preds = preds.to(f32)
    scores = scores.to(f32)
    scores = torch.where(scores == 0, 1e-5, scores)        # pPose_nms.py:40

    widths = bboxes[..., 2] - bboxes[..., 0]
    heights = bboxes[..., 3] - bboxes[..., 1]
    ref_dists = ALPHA * torch.maximum(widths, heights)     # pPose_nms.py:52
    human_scores = scores.mean(dim=-1)                     # [B,N]

    # d[b, p, j, kp] = |preds[b,p,kp] - preds[b,j,kp]|
    d = torch.sqrt(((preds[:, :, None] - preds[:, None]) ** 2).sum(dim=-1))

    # simi[b, p, j]: parametric distance of candidate j to pick p (score
    # term masked by dist <= 1, point term not; pPose_nms.py:244-268)
    tanh_s = torch.tanh(scores / DELTA1)
    score_d = torch.where(d <= 1.0, tanh_s[:, :, None] * tanh_s[:, None],
                          0.0)
    simi = score_d.sum(dim=-1) + MU * torch.exp(-d / delta2).sum(dim=-1)
    # n_match[b, p, j]: PCK matches against pick p (pPose_nms.py:271-281)
    pck_ref = ref_dists.clamp_max(7.0)[:, :, None, None]
    n_match = (d / pck_ref <= 1.0).sum(dim=-1)
    deletes = (simi > GAMMA) | (n_match >= MATCH_THRESH)   # [B,N,N]

    idx = torch.arange(n, device=scores.device)
    alive = valid.to(torch.bool)
    picked = torch.zeros_like(alive)
    merge_mat = torch.zeros(b, n, n, dtype=torch.bool, device=scores.device)
    neg_inf = torch.tensor(-torch.inf, device=scores.device)
    for _ in range(n):
        any_alive = alive.any(dim=1, keepdim=True)         # [B,1]
        p = torch.where(alive, human_scores, neg_inf).argmax(dim=1)
        is_p = idx == p[:, None]                           # [B,N]
        del_row = alive & deletes.gather(
            1, p[:, None, None].expand(-1, 1, n))[:, 0]
        # empty delete set -> delete the pick alone (pPose_nms.py:75-76);
        # always include the pick (the termination guard above)
        del_row = torch.where(del_row.any(dim=1, keepdim=True), del_row,
                              is_p)
        del_row = (del_row | is_p) & alive & any_alive
        picked = picked | (is_p & alive & any_alive)
        merge_mat = torch.where((is_p & any_alive)[:, :, None],
                                del_row[:, None, :], merge_mat)
        alive = alive & ~del_row

    # score-weighted merge for every pick at once (p_merge_fast)
    merge_ref = ref_dists.clamp_max(15.0)[:, :, None, None]
    m_scores = scores[:, None] * ((d <= merge_ref) & merge_mat[..., None])
    denom = m_scores.sum(dim=2)                            # [B,N,K]
    denom = torch.where(denom == 0, 1e-12, denom)
    normed = m_scores / denom[:, :, None]                  # [B,N,N,K]
    final_pose = torch.einsum("bpjk,bjkc->bpkc", normed, preds)
    final_score = (m_scores * normed).sum(dim=2)           # [B,N,K]

    # filters and proposal score (pPose_nms.py:101-121)
    f_pick = scores.amax(dim=-1) >= SCORE_THRESH
    max_fs = final_score.amax(dim=-1)
    f_merge = max_fs >= SCORE_THRESH
    span_x = final_pose[..., 0].amax(-1) - final_pose[..., 0].amin(-1)
    span_y = final_pose[..., 1].amax(-1) - final_pose[..., 1].amin(-1)
    f_area = 1.5 ** 2 * span_x * span_y >= AREA_THRESH
    proposal = final_score.mean(dim=-1) + bbox_scores + 1.25 * max_fs

    survive = picked & f_pick & f_merge & f_area
    best = torch.where(survive, proposal, neg_inf).argmax(dim=1)   # [B]

    def take(t):
        return t[torch.arange(b, device=t.device), best]

    out = (take(final_pose) + KP_OFFSET, take(final_score), take(proposal),
           take(bboxes), take(bbox_scores), survive.any(dim=1))
    if extra is not None:
        final_extra = torch.einsum("bpjk,bjk->bpk", normed, extra.to(f32))
        out = out + (take(final_extra),)
    return out


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
