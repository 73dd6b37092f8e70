"""Host-side frame and video IO: image loading, extract → frame files →
assemble, and the streaming decode/encode threads.

The port's copy of the JAX engine's ``io/frames.py`` (the port imports
nothing of the JAX package). Extraction and assembly run ffmpeg's filter
graphs (Lanczos scale, canvas fit+pad, fps select, libx264 yuv420p) when
the ``ffmpeg`` binary is on PATH, else OpenCV with the same semantics. The
streaming path decodes and encodes on background threads, so host video IO
overlaps device compute and no frame files are written: the same fps
selection by timestamp, long-side Lanczos scale, canvas fit+pad with black
bars, and output-clock resampling by forward duplicate/drop. OpenCV and PIL
are imported lazily, by the functions that use them.
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path

import numpy as np


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def load_image_exif_rgb(path: str):
    """PIL load with the reference's manual EXIF rotation (only orientations
    3, 6 and 8), as RGB."""
    from PIL import ExifTags, Image

    img = Image.open(path)
    exif = getattr(img, "_getexif", lambda: None)()
    orientation = None
    if exif:
        for tag, value in exif.items():
            if ExifTags.TAGS.get(tag) == "Orientation":
                orientation = value
                break
    if orientation == 3:
        img = img.rotate(180, expand=True)
    elif orientation == 6:
        img = img.rotate(270, expand=True)
    elif orientation == 8:
        img = img.rotate(90, expand=True)
    return img.convert("RGB")


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


def _src_fps(input_video: Path) -> float:
    import cv2

    cap = cv2.VideoCapture(str(input_video))
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    cap.release()
    return float(fps)


def _verify_frames(frames_dir: Path, ext: str) -> int:
    """PIL-verify every extracted frame; returns their count."""
    from PIL import Image

    n = 0
    for frame_path in sorted(frames_dir.glob(f"frame_*.{ext}")):
        with Image.open(frame_path) as img:
            img.verify()
        n += 1
    return n


def _extract_frames_ffmpeg(input_video: Path, frames_dir: Path, fps: int | None,
                           scale: int | None, img_ext: str, jpeg_quality: int,
                           canvas_wh: tuple[int, int] | None, max_frames: int | None) -> float:
    """The reference's ffmpeg extraction graph."""
    vf_parts: list[str] = []
    if canvas_wh:
        cw, ch = canvas_wh
        vf_parts.append(f"scale={cw}:{ch}:flags=lanczos:force_original_aspect_ratio=decrease")
        vf_parts.append(f"pad={cw}:{ch}:(ow-iw)/2:(oh-ih)/2:color=black")
    elif scale:
        vf_parts.append(f"scale='if(gte(iw,ih),{scale},-2)':'if(gte(ih,iw),{scale},-2)'"
                        ":flags=lanczos")
    if fps:
        vf_parts.append(f"fps={fps}")
    ext = "png" if img_ext.lower() == "png" else "jpg"
    cmd = ["ffmpeg", "-y", "-i", str(input_video)]
    if vf_parts:
        cmd += ["-vf", ",".join(vf_parts)]
    if max_frames:
        cmd += ["-frames:v", str(max_frames)]
    if ext == "jpg":
        # mjpeg qscale is 2 (best) .. 31, mapped from the 0-100 quality knob
        q = max(2, min(31, round(2 + (100 - int(jpeg_quality)) * 29 / 98)))
        cmd += ["-c:v", "mjpeg", "-q:v", str(q), "-pix_fmt", "yuvj420p"]
    cmd += [str(frames_dir / f"frame_%04d.{ext}")]
    subprocess.run(cmd, check=True, capture_output=True)
    if _verify_frames(frames_dir, ext) == 0:
        raise RuntimeError(f"no frames extracted from {input_video}")
    return _src_fps(input_video)


def extract_frames(input_video: Path, frames_dir: Path, fps: int | None, scale: int | None,
                   img_ext: str, jpeg_quality: int, canvas_wh: tuple[int, int] | None = None,
                   max_frames: int | None = None) -> float:
    """Decode a video into ``frame_%04d.{ext}`` files; returns the source fps.
    With ``fps`` set, frames are picked by timestamp to hit the target rate
    (ffmpeg's fps-filter semantics). ffmpeg when available, else OpenCV."""
    import cv2

    frames_dir.mkdir(parents=True, exist_ok=True)
    if have_ffmpeg():
        try:
            return _extract_frames_ffmpeg(input_video, frames_dir, fps, scale, img_ext,
                                          jpeg_quality, canvas_wh, max_frames)
        except (subprocess.CalledProcessError, OSError) as e:
            print(f"[frames][WARN] ffmpeg extraction failed ({e}); falling back to OpenCV")

    cap = cv2.VideoCapture(str(input_video))
    if not cap.isOpened():
        raise RuntimeError(f"cannot open video: {input_video}")
    src_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    ext = "png" if img_ext.lower() == "png" else "jpg"
    out_idx = in_idx = 0
    next_t = 0.0
    step = (1.0 / fps) if fps else None
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        t = in_idx / src_fps
        in_idx += 1
        if step is not None:
            if t + 1e-9 < next_t:
                continue
            next_t += step
        out_idx += 1
        frame = _fit_scale_pad(frame, scale, canvas_wh)
        path = frames_dir / f"frame_{out_idx:04d}.{ext}"
        if ext == "jpg":
            cv2.imwrite(str(path), frame, [cv2.IMWRITE_JPEG_QUALITY, int(jpeg_quality)])
        else:
            cv2.imwrite(str(path), frame)
        if max_frames and out_idx >= max_frames:
            break
    cap.release()
    _verify_frames(frames_dir, ext)
    if out_idx == 0:
        raise RuntimeError(f"no frames extracted from {input_video}")
    return float(src_fps)


def _assemble_video_ffmpeg(frames_dir: Path, output_video: Path, framerate_in: float,
                           fps_out: float | None, pattern_prefix: str) -> int:
    """The reference's ffmpeg assembly command."""
    jpgs = sorted(frames_dir.glob(f"{pattern_prefix}_*.jpg"))
    pngs = sorted(frames_dir.glob(f"{pattern_prefix}_*.png"))
    if jpgs:
        pattern, n_in = frames_dir / f"{pattern_prefix}_%04d.jpg", len(jpgs)
    elif pngs:
        pattern, n_in = frames_dir / f"{pattern_prefix}_%04d.png", len(pngs)
    else:
        raise RuntimeError(f"no {pattern_prefix}_* frames in {frames_dir}")
    cmd = ["ffmpeg", "-y", "-framerate", str(framerate_in), "-i", str(pattern)]
    if fps_out:
        cmd += ["-r", str(fps_out)]
    cmd += ["-c:v", "libx264", "-pix_fmt", "yuv420p", str(output_video)]
    subprocess.run(cmd, check=True, capture_output=True)
    if fps_out and abs(float(fps_out) - float(framerate_in)) > 1e-6:
        return max(1, int(round(n_in / framerate_in * fps_out)))
    return n_in


def assemble_video(frames_dir: Path, output_video: Path, framerate_in: float,
                   fps_out: float | None, pattern_prefix: str = "styled_frame") -> int:
    """A frame sequence → H.264 mp4. ``framerate_in`` paces the frames;
    ``fps_out`` resamples the output timeline (ffmpeg ``-framerate in -r
    out``; OpenCV duplicates or drops frames onto the output clock).
    Returns the frames written."""
    import cv2

    output_video.parent.mkdir(parents=True, exist_ok=True)
    if have_ffmpeg():
        try:
            return _assemble_video_ffmpeg(frames_dir, output_video, framerate_in, fps_out,
                                          pattern_prefix)
        except (subprocess.CalledProcessError, OSError) as e:
            print(f"[frames][WARN] ffmpeg assembly failed ({e}); falling back to OpenCV")

    files = sorted(list(frames_dir.glob(f"{pattern_prefix}_*.jpg"))
                   + list(frames_dir.glob(f"{pattern_prefix}_*.png")))
    if not files:
        raise RuntimeError(f"no {pattern_prefix}_* frames in {frames_dir}")
    h, w = cv2.imread(str(files[0])).shape[:2]
    out_fps = float(fps_out or framerate_in)
    for fourcc_name in ("avc1", "mp4v"):
        writer = cv2.VideoWriter(str(output_video), cv2.VideoWriter_fourcc(*fourcc_name),
                                 out_fps, (w, h))
        if writer.isOpened():
            break
    if not writer.isOpened():
        raise RuntimeError("no usable mp4 encoder in OpenCV build")
    n_out = 0
    if fps_out and abs(out_fps - framerate_in) > 1e-6:
        total_out = max(1, int(round(len(files) / framerate_in * out_fps)))
        for k in range(total_out):
            src = min(len(files) - 1, int(k / out_fps * framerate_in))
            writer.write(cv2.imread(str(files[src])))
            n_out += 1
    else:
        for f in files:
            writer.write(cv2.imread(str(f)))
            n_out += 1
    writer.release()
    return n_out


def write_mp4(path, frames, fps, *, rgb: bool = True) -> None:
    """uint8 frames (RGB, or BGR with ``rgb=False``) → an mp4 through
    OpenCV, avc1 where the build has it, else mp4v: the apps' writer."""
    import cv2

    h, w = frames[0].shape[:2]
    for fourcc in ("avc1", "mp4v"):
        writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
        if writer.isOpened():
            break
    for f in frames:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR) if rgb else f)
    writer.release()


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
