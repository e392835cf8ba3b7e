"""Video / webcam frame sources.

Capability parity with the reference's `VideoLoader` (`dataloader.py:192`),
`VideoDetectionLoader` (`:468`) and `WebcamLoader` (`:590`) — but as plain
prefetching iterators feeding the device pipeline instead of queue-chained
worker threads.  A copy of `betapose_tpu/data/video.py` (cv2 only; the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import threading
import queue as queue_mod

import numpy as np


class VideoLoader:
    """Iterate uint8 RGB frame batches [B,H,W,3] from a video file."""

    def __init__(self, path: str, batch_size: int = 4):
        import cv2
        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise IOError(f"cannot open video {path}")
        self.batch_size = batch_size
        self.n_real = 0
        self.fps = self.cap.get(cv2.CAP_PROP_FPS)
        self.frame_count = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.w = int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.h = int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT))

    def videoinfo(self):
        """(fourcc, fps, frameSize) like the reference VideoLoader."""
        import cv2
        fourcc = int(self.cap.get(cv2.CAP_PROP_FOURCC))
        return fourcc, self.fps, (self.w, self.h)

    def __iter__(self):
        """Batches of `batch_size` frames; the last is padded by repeating
        its last frame, and `n_real` holds the count of real frames in the
        batch last yielded."""
        frames = []
        while True:
            ok, frame = self.cap.read()
            if not ok:
                break
            frames.append(frame[:, :, ::-1])  # BGR -> RGB
            if len(frames) == self.batch_size:
                self.n_real = len(frames)
                yield np.stack(frames)
                frames = []
        if frames:
            self.n_real = len(frames)
            while len(frames) < self.batch_size:   # pad tail
                frames.append(frames[-1])
            yield np.stack(frames)
        self.cap.release()


class WebcamLoader:
    """Latest-frame webcam source: a reader thread keeps only the freshest
    frame (the reference's WebcamLoader drops stale frames the same way,
    dataloader.py:607-627)."""

    def __init__(self, webcam: str = "0"):
        import cv2
        self.cap = cv2.VideoCapture(int(webcam) if str(webcam).isdigit()
                                    else webcam)
        if not self.cap.isOpened():
            raise IOError(f"cannot open webcam {webcam}")
        self.q: queue_mod.Queue = queue_mod.Queue(maxsize=2)
        self.stopped = False
        self.thread = threading.Thread(target=self._reader, daemon=True)
        self.thread.start()

    def _reader(self):
        while not self.stopped:
            ok, frame = self.cap.read()
            if not ok:
                break
            if self.q.full():
                try:
                    self.q.get_nowait()
                except queue_mod.Empty:
                    pass
            self.q.put(frame[:, :, ::-1])
        self.cap.release()

    def read(self, timeout=5.0):
        return self.q.get(timeout=timeout)

    def stop(self):
        self.stopped = True


class VideoWriter:
    """Rendered-output writer (DataWriter's save_video capability,
    dataloader.py:649-657)."""

    def __init__(self, path: str, fps: float, frame_size, fourcc="XVID"):
        import cv2
        self.stream = cv2.VideoWriter(
            path, cv2.VideoWriter_fourcc(*fourcc), fps, frame_size)
        if not self.stream.isOpened():
            raise IOError(f"cannot open video writer {path}")

    def write_rgb(self, frame_rgb: np.ndarray):
        self.stream.write(np.ascontiguousarray(frame_rgb[:, :, ::-1]))

    def release(self):
        self.stream.release()


def draw_pose_overlay(frame_rgb, box=None, keypoints=None, kp_scores=None,
                      score_thresh=0.3):
    """Render detection box + keypoints onto a frame (the reference's
    vis_frame capability, fn.py commented renderers)."""
    import cv2
    img = np.ascontiguousarray(frame_rgb.copy())
    if box is not None:
        x1, y1, x2, y2 = (int(v) for v in box)
        cv2.rectangle(img, (x1, y1), (x2, y2), (255, 60, 60), 2)
    if keypoints is not None:
        for i, (x, y) in enumerate(np.asarray(keypoints)):
            if kp_scores is not None and kp_scores[i] < score_thresh:
                continue
            cv2.circle(img, (int(x), int(y)), 2, (60, 220, 60), -1)
    return img
