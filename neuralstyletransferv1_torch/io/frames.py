"""Streaming video IO: decode and encode on background threads, so host
video IO overlaps device compute and no frame files are written.

The port's copy of the streaming part of the JAX engine's ``io/frames.py``
(the port imports nothing of the JAX package): the same fps selection by
timestamp, long-side Lanczos scale, canvas fit+pad with black bars, and
output-clock resampling by forward duplicate/drop. OpenCV is imported
lazily, only by a video job.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _fit_scale_pad(frame_bgr: np.ndarray, scale: int | None,
                   canvas_wh: tuple[int, int] | None) -> np.ndarray:
    import cv2

    h, w = frame_bgr.shape[:2]
    if canvas_wh:
        cw, ch = canvas_wh
        # fit inside the canvas preserving the aspect ratio, then pad black
        s = min(cw / w, ch / h)
        nw, nh = max(1, int(round(w * s))), max(1, int(round(h * s)))
        resized = cv2.resize(frame_bgr, (nw, nh), interpolation=cv2.INTER_LANCZOS4)
        out = np.zeros((ch, cw, 3), np.uint8)
        x0, y0 = (cw - nw) // 2, (ch - nh) // 2
        out[y0 : y0 + nh, x0 : x0 + nw] = resized
        return out
    if scale:
        # long side → scale, the other side keeps the aspect ratio, rounded
        # to even
        if w >= h:
            nw = scale
            nh = int(round(h * scale / w / 2)) * 2
        else:
            nh = scale
            nw = int(round(w * scale / h / 2)) * 2
        return cv2.resize(frame_bgr, (nw, nh), interpolation=cv2.INTER_LANCZOS4)
    return frame_bgr


class VideoFrameStream:
    """Background-thread decoder → bounded queue of RGB uint8 frames."""

    def __init__(self, input_video, fps=None, scale=None, canvas_wh=None,
                 max_frames=None, queue_frames=64):
        import queue
        import threading

        import cv2

        self._cap = cv2.VideoCapture(str(input_video))
        if not self._cap.isOpened():
            raise RuntimeError(f"cannot open video: {input_video}")
        self.src_fps = float(self._cap.get(cv2.CAP_PROP_FPS) or 30.0)
        n_est = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
        if fps and n_est:
            n_est = int(n_est / self.src_fps * fps) + 1
        if max_frames and n_est:
            n_est = min(n_est, max_frames)
        self.estimated_frames = n_est or None
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_frames)
        self._stop = threading.Event()
        self._args = (fps, scale, canvas_wh, max_frames)
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        import cv2

        fps, scale, canvas_wh, max_frames = self._args
        in_idx = out_idx = 0
        next_t = 0.0
        step = (1.0 / fps) if fps else None
        while not self._stop.is_set():
            ok, frame = self._cap.read()
            if not ok:
                break
            t = in_idx / self.src_fps
            in_idx += 1
            if step is not None:
                if t + 1e-9 < next_t:
                    continue
                next_t += step
            frame = _fit_scale_pad(frame, scale, canvas_wh)
            self._q.put(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            out_idx += 1
            if max_frames and out_idx >= max_frames:
                break
        self._cap.release()
        self._q.put(None)

    def __iter__(self):
        while True:
            f = self._q.get()
            if f is None:
                return
            yield f

    def close(self):
        self._stop.set()
        try:
            while self._q.get_nowait() is not None:
                pass
        except Exception:
            pass


class VideoStreamWriter:
    """Background-thread mp4 encoder for RGB uint8 frames.

    ``framerate_in`` paces the incoming frames; ``fps_out`` resamples onto
    the output clock by forward duplicate/drop (the source index is
    monotonic, so it streams)."""

    def __init__(self, output_video, framerate_in, fps_out=None, queue_frames=64):
        import queue
        import threading

        Path(output_video).parent.mkdir(parents=True, exist_ok=True)
        self._path = str(output_video)
        self._fin = float(framerate_in)
        self._fout = float(fps_out or framerate_in)
        self._resample = fps_out is not None and abs(self._fout - self._fin) > 1e-6
        self._writer = None
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_frames)
        self._err = None
        self.written = 0
        self._n_in = 0
        self._k = 0  # output-clock counter for the resampler
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _open(self, w, h):
        import cv2

        for fourcc_name in ("avc1", "mp4v"):
            fourcc = cv2.VideoWriter_fourcc(*fourcc_name)
            writer = cv2.VideoWriter(self._path, fourcc, self._fout, (w, h))
            if writer.isOpened():
                return writer
        raise RuntimeError("no usable mp4 encoder in OpenCV build")

    def _run(self):
        import cv2

        try:
            while True:
                item = self._q.get()
                if item is None:
                    return
                bgr = cv2.cvtColor(item, cv2.COLOR_RGB2BGR)
                if self._writer is None:
                    self._writer = self._open(bgr.shape[1], bgr.shape[0])
                i = self._n_in
                self._n_in += 1
                if self._resample:
                    # write frame i for every output tick whose source is i
                    while int(self._k / self._fout * self._fin) == i:
                        self._writer.write(bgr)
                        self.written += 1
                        self._k += 1
                else:
                    self._writer.write(bgr)
                    self.written += 1
        except Exception as e:  # surfaced on close()
            self._err = e

    def write(self, frame_rgb_u8):
        if self._err is not None:
            raise self._err
        self._q.put(frame_rgb_u8)

    def close(self) -> int:
        self._q.put(None)
        self._t.join()
        if self._writer is not None:
            self._writer.release()
        if self._err is not None:
            raise self._err
        return self.written
