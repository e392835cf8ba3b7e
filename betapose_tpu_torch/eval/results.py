"""Result accumulation and Betapose-results.json export.

The JSON schema is the reference's public output API (`pPose_nms.py:284-371`,
SURVEY.md 5.5): per detection — image_id, cam_R (9 floats), cam_t (3 floats),
keypoints (x, y, score interleaved, 3*K floats), score (proposal score);
with 'cmu' and 'open' export variants that regroup keypoints into
CMU-Pose / OpenPose body dictionaries and also write per-image `sep-json/`
files.
"""

from __future__ import annotations

import json
import os

import numpy as np


def make_frame_result(im_name, result_list, cam_R, cam_t):
    """One frame's entry, shaped like the reference DataWriter accumulation
    (`dataloader.py:703-733`)."""
    return {"imgname": im_name, "result": result_list,
            "cam_R": cam_R, "cam_t": cam_t}


def _keypoints_flat(kp_preds, kp_scores):
    out = []
    for n in range(len(kp_scores)):
        out.append(float(kp_preds[n, 0]))
        out.append(float(kp_preds[n, 1]))
        out.append(float(np.asarray(kp_scores[n]).reshape(-1)[0]))
    return out


_CMU_INDEX_ARR = [0, 51, 18, 24, 30, 15, 21, 27, 36, 42, 48, 33, 39, 45,
                  6, 3, 12, 9]


def _cmu_entry(result):
    """Shared CMU/OpenPose joint regrouping (pPose_nms.py:319-349)."""
    kp = list(result["keypoints"])
    kp.append((kp[15] + kp[18]) / 2)
    kp.append((kp[16] + kp[19]) / 2)
    kp.append((kp[50] + kp[20]) / 2)
    joints = []
    for i in _CMU_INDEX_ARR:
        joints.extend([kp[i], kp[i + 1], kp[i + 2]])
    return joints


def write_json(all_results, outputpath, for_eval=False, form=None):
    """Reference-compatible writer (`pPose_nms.py:284-371`)."""
    json_results = []
    json_results_cmu = {}
    for im_res in all_results:
        im_name = im_res["imgname"]
        cam_R = im_res["cam_R"]
        cam_t = im_res["cam_t"]
        for human in im_res["result"]:
            result = {}
            if for_eval:
                result["image_id"] = int(
                    im_name.split("/")[-1].split(".")[0].split("_")[-1])
            else:
                result["image_id"] = im_name.split("/")[-1]
            if len(np.asarray(cam_R).reshape(-1)) > 0:
                result["cam_R"] = np.asarray(cam_R).reshape(9).tolist()
                result["cam_t"] = np.asarray(cam_t).reshape(3).tolist()
            result["keypoints"] = _keypoints_flat(
                np.asarray(human["keypoints"]), np.asarray(human["kp_score"]))
            result["score"] = float(human["proposal_score"])

            if form in ("cmu", "open"):
                key = result["image_id"]
                if key not in json_results_cmu:
                    if form == "cmu":
                        json_results_cmu[key] = {
                            "version": "Betapose v1.0", "bodies": []}
                    else:
                        json_results_cmu[key] = {
                            "version": "Betapose v0.2", "people": []}
                joints = _cmu_entry(result)
                if form == "cmu":
                    json_results_cmu[key]["bodies"].append({"joints": joints})
                else:
                    json_results_cmu[key]["people"].append(
                        {"pose_keypoints_2d": joints})
            else:
                json_results.append(result)

    os.makedirs(outputpath, exist_ok=True)
    out_file = os.path.join(outputpath, "Betapose-results.json")
    if form in ("cmu", "open"):
        with open(out_file, "w") as f:
            f.write(json.dumps(json_results_cmu))
        sep = os.path.join(outputpath, "sep-json")
        os.makedirs(sep, exist_ok=True)
        for name in json_results_cmu:
            with open(os.path.join(
                    sep, str(name).split(".")[0] + ".json"), "w") as f:
                f.write(json.dumps(json_results_cmu[name]))
    else:
        with open(out_file, "w") as f:
            f.write(json.dumps(json_results))
    print("Results have been written to", out_file)
    return out_file
