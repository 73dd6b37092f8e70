"""The engine: decode → stylize → DIS flow → temporal chain → encode, for
videos and images.

Counterpart of ``neuralstyletransferv1_tpu/engine/pipeline.py``, with the
same CLI surface (``engine/config.build_arg_parser``, a copy of the JAX
engine's) and the same three runners:

- ``style_video_stream`` (video, ``--frame_batch`` > 1, ``--stream auto``):
  decode → device batches → encode, no frame files;
- ``style_frames_batched`` (``--frame_batch`` > 1 on frame files: ``--stream
  off`` after extraction, and the batch image mode): device batches over
  ``frame_*`` files, read ahead by a thread pool;
- ``style_frames`` (the default ``--frame_batch 1``, and the single-image
  mode): the per-frame loop.

The batched runners share ``make_batched_core``: frames cross to the device
as uint8 and convert there, the temporal state stays on the device between
batches, and the previous batch's frames are copied back and written while
the device works on the next one.

Flags outside these paths raise ``NotImplementedError`` naming the
ROADMAP.md item that ports them; none is silently ignored.
"""

from __future__ import annotations

import re
import sys
import time
import uuid
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..io import frames as fio
from .config import build_arg_parser

_LETTERS = "abcdefgh"

# ROADMAP.md "Queue 1 — port slices" items that port each unsupported mode.
_QUANT_F32 = "ROADMAP.md Queue 1, item 10 (--quantize under float32)"
_REGIONS = "ROADMAP.md Queue 1, item 4 (regions, masks, LAB multi-slot blend)"
_BACKENDS = "ROADMAP.md Queue 1, item 6 (other stylizer backends, Farneback flow)"
_MULTI = "ROADMAP.md Queue 1, item 8 (multi-GPU)"
_BENCH = "ROADMAP.md Queue 1, item 9 (bench and tracing)"


def effective_flow_downscale(flow_downscale: int, h: int, w: int) -> int:
    """Resolve --flow_downscale 0 (auto): 2 when the half-resolution frame
    still holds the full DIS pyramid (min dim >= 512), else 1."""
    if flow_downscale <= 0:
        return 2 if min(h, w) >= 512 else 1
    return flow_downscale


def flows_at_downscale(args, prevs: torch.Tensor, grays: torch.Tensor) -> torch.Tensor:
    """DIS flow prevs[i] → grays[i] ([N,H,W] gray) at the auto/explicit
    --flow_downscale, scaled back to the frame size: [N,H,W,2]."""
    from ..ops.dis_flow import dis_flow
    from ..ops.resize import resize_bilinear

    H, W = grays.shape[1], grays.shape[2]
    ds = effective_flow_downscale(int(args.flow_downscale), H, W)
    if ds <= 1:
        return dis_flow(prevs, grays)
    hs, ws = H // ds, W // ds
    f_small = dis_flow(resize_bilinear(prevs[..., None], (hs, ws))[..., 0],
                       resize_bilinear(grays[..., None], (hs, ws))[..., 0])
    return resize_bilinear(f_small, (H, W)) * float(ds)


def parse_blend_weights(weights_str: str | None, num_models: int) -> list[float]:
    if not weights_str:
        return [1.0 / num_models] * num_models
    weights = [float(w) for w in weights_str.split(",")]
    if len(weights) != num_models:
        raise ValueError(f"Expected {num_models} weights, got {len(weights)}")
    if abs(sum(weights) - 1.0) > 1e-6:
        raise ValueError(f"Weights must sum to 1.0, got {sum(weights):.6f}")
    return weights


def build_parser():
    """The shared CLI surface, with ``--device`` defaulting to cuda."""
    ap = build_arg_parser()
    ap.set_defaults(device="cuda")
    return ap


def check_supported(args) -> None:
    """Raise NotImplementedError for every flag this port does not run yet."""
    unsupported = [
        (bool(args.region_mode or args.region_optimize), "--region_* modes", _REGIONS),
        (bool(args.mask or args.mask_dir), "--mask / --mask_dir", _REGIONS),
        (args.blend_models_lab, "--blend_models_lab", _REGIONS),
        (args.quantize != "none" and args.compute_dtype != "bfloat16",
         f"--quantize {args.quantize} with --compute_dtype {args.compute_dtype}", _QUANT_F32),
        (int(args.mesh_devices or 0) > 1, "--mesh_devices > 1", _MULTI),
        (args.flow_method != "dis", f"--flow_method {args.flow_method}", _BACKENDS),
        (bool(args.profile_dir), "--profile_dir", _BENCH),
    ]
    for path, model_type, _preset, magenta_style in _slot_args(args):
        other = path and (model_type not in ("transformer", "reconet")
                          or Path(path).suffix.lower() == ".t7")
        unsupported.append((bool(other or (model_type == "magenta" and magenta_style)),
                            f"{model_type} slot {path or magenta_style}", _BACKENDS))
    for bad, what, item in unsupported:
        if bad:
            raise NotImplementedError(f"{what} is not ported to PyTorch yet: {item}")


def _slot_args(args):
    """(checkpoint, model type, IO preset, magenta style) of slots A..H."""
    yield args.model, args.model_type, args.io_preset, args.magenta_style
    for letter in _LETTERS[1:]:
        yield (getattr(args, f"model_{letter}"), getattr(args, f"model_{letter}_type"),
               getattr(args, f"io_preset_{letter}"), getattr(args, f"magenta_style_{letter}"))


def load_slot_bank(args, device) -> list:
    """The Johnson, NST_Train and ReCoNet checkpoints of slots A..H, on
    ``device``."""
    from . import stylizer as st

    return [st.load_model(path, model_type=model_type, io_preset=io_preset, device=device)
            for path, model_type, io_preset, _style in _slot_args(args) if path]


def list_frame_files(args, frames_dir: Path) -> list[Path]:
    """The ``frame_*`` files of ``frames_dir`` in order, then ``--stride`` and
    ``--max_frames``; exits 2 when there is none."""
    frame_files = sorted(list(frames_dir.glob("frame_*.png"))
                         + list(frames_dir.glob("frame_*.jpg"))
                         + list(frames_dir.glob("frame_*.jpeg")))
    frame_files = frame_files[::max(1, args.stride)]
    if args.max_frames:
        frame_files = frame_files[:args.max_frames]
    if not frame_files:
        print(f"[error] no frames found in {frames_dir}")
        sys.exit(2)
    return frame_files


def _out_path(args, frames_dir: Path, frame_path: Path, idx: int, image_mode: bool,
              save_map: dict[int, str]) -> tuple[Path, bool]:
    """Where styled frame ``idx`` (1-based) goes, and whether as JPEG: the
    image mode's target for that frame, else ``<output_prefix>_<n>`` beside
    the frames."""
    if image_mode and idx in save_map:
        out = Path(save_map[idx])
        out.parent.mkdir(parents=True, exist_ok=True)
        return out, out.suffix.lower() in (".jpg", ".jpeg")
    jpg = args.image_ext.lower() == "jpg"
    stem = f"{args.output_prefix}_{frame_path.stem.split('_')[-1]}"
    return (frames_dir / stem).with_suffix(".jpg" if jpg else ".png"), jpg


def _save(img_u8: np.ndarray, out_path: Path, jpg: bool, quality: int) -> None:
    from PIL import Image

    img = Image.fromarray(img_u8)
    if jpg:
        img.save(out_path, format="JPEG", quality=int(quality))
    else:
        img.save(out_path)


def make_batched_core(args, device: torch.device, *, fused_sites=None):
    """The per-batch pipeline: slot-bank stylize → RGB slot blend → DIS flow
    → temporal chain, uint8 in and out. ``fused_sites``: the fused-site set
    (``jit_stylizer``): None is the adopted one in the int8 modes and no
    fused site otherwise; ``head``, ``tail`` and ``d3`` name the bf16 sites.

    Returns (B, process_batch) where ``process_batch(imgs: list[np.uint8
    HWC]) -> device uint8 [B,H,W,3]``; the temporal state carries across
    calls. ``--inference_res`` stylizes at that long side (the size fixed by
    the first batch) and resizes the outputs back to the frame size.
    """
    from ..ops.color import rgb_to_gray
    from ..ops.resize import resize_bilinear
    from ..temporal.ema import temporal_postprocess_split
    from . import stylizer as st

    check_supported(args)
    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    models = load_slot_bank(args, device)
    num_models = len(models)
    print(f"[bank] {num_models} slot(s): "
          + ", ".join(f"{m.name}({m.arch}/{m.io_preset})" for m in models))
    stylize_fns = [st.jit_stylizer(m, dtype=dtype, quantize=args.quantize, fused_sites=fused_sites)
                   for m in models]
    weights = parse_blend_weights(args.blend_models_weights, num_models) \
        if num_models > 1 else [1.0]
    w_slots = torch.tensor(weights, dtype=torch.float32, device=device)[:, None, None, None, None]

    B = max(1, int(args.frame_batch))
    chain_kwargs = dict(
        flow_ema=args.flow_ema, flow_alpha=args.flow_alpha,
        smooth_lightness=args.smooth_lightness, smooth_chroma=args.smooth_chroma,
        smooth_alpha=args.smooth_alpha, chroma_alpha=args.chroma_alpha,
        motion_blend=args.motion_blend, blend=args.blend,
        fast_warp=not args.exact_warp,
    )
    carry = {"state": None, "prev_gray": None, "infer_hw": None}

    @torch.no_grad()
    def process_batch(imgs: list) -> torch.Tensor:
        imgs = list(imgs)
        while len(imgs) < B:  # pad the final batch; its extra outputs are dropped
            imgs.append(imgs[-1])
        u8 = torch.from_numpy(np.stack(imgs, 0))
        if device.type == "cuda":
            u8 = u8.pin_memory().to(device, non_blocking=True)
        orig = u8.float() / 255.0
        grays = rgb_to_gray(orig * 255.0)
        H0, W0 = orig.shape[1], orig.shape[2]

        src = orig
        if args.inference_res and max(H0, W0) > args.inference_res:
            if carry["infer_hw"] is None:
                s = args.inference_res / max(H0, W0)
                carry["infer_hw"] = (int(round(H0 * s)), int(round(W0 * s)))
            src = resize_bilinear(orig, carry["infer_hw"])
        # each slot's output, locked to the content size
        outs = [o if o.shape[1:3] == (H0, W0) else resize_bilinear(o, (H0, W0))
                for o in (fn(src) for fn in stylize_fns)]
        styled = (w_slots * torch.stack(outs, 0)).sum(dim=0).clamp(0.0, 1.0)

        if carry["state"] is None:  # first batch: frame 0 is its own predecessor
            carry["prev_gray"] = grays[0]
        flows = None
        if args.flow_ema:
            prevs = torch.cat([carry["prev_gray"][None], grays[:-1]], 0)
            flows = flows_at_downscale(args, prevs, grays)
        out, carry["state"] = temporal_postprocess_split(
            styled, orig, flows, init=carry["state"], **chain_kwargs)
        carry["prev_gray"] = grays[-1]
        return (out.clamp(0.0, 1.0) * 255.0).to(torch.uint8)

    return B, process_batch


class _HostCopy:
    """A batch's uint8 frames on their way to the host: the copy is queued
    behind the batch's compute, and ``wait`` blocks only on that copy, so the
    host encodes batch k while the device runs batch k+1."""

    def __init__(self, out_dev: torch.Tensor, n_real: int):
        self.n = n_real
        if out_dev.device.type == "cuda":
            self.host = torch.empty(out_dev.shape, dtype=torch.uint8, pin_memory=True)
            self.host.copy_(out_dev, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = out_dev, None

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def style_video_stream(args, device: torch.device):
    """Streaming video path: decode → device batches → encode, with no frame
    files. Decode and encode run on the shared io/frames background threads.

    Returns (written_frames, streamed_frames, src_fps).
    """
    B, process_batch = make_batched_core(args, device)
    canvas_wh = None
    if args.canvas:
        cw, ch = args.canvas.lower().split("x")
        canvas_wh = (int(cw), int(ch))
    stream = fio.VideoFrameStream(
        Path(args.input_video).resolve(), fps=args.pre_fps or args.fps, scale=args.scale,
        canvas_wh=canvas_wh, max_frames=args.max_frames,
    )
    framerate_in = float(args.pre_fps or args.fps or stream.src_fps or 24)
    fps_out = float(args.fps) if (args.pre_fps and args.fps) else None
    writer = fio.VideoStreamWriter(Path(args.output_video).resolve(), framerate_in, fps_out)
    est = stream.estimated_frames

    t_start = time.perf_counter()
    streamed = 0
    pending: _HostCopy | None = None

    def flush(ent: _HostCopy):
        frames = ent.wait()
        for i in range(ent.n):
            writer.write(frames[i])
        fps_now = streamed / max(1e-9, time.perf_counter() - t_start)
        total = f"/{est}" if est else ""
        print(f"[stream][{streamed}{total}] {fps_now:.1f} frames/s cumulative")

    try:
        batch_imgs: list = []
        it = iter(stream)
        while True:
            frame = next(it, None)
            if frame is not None:
                batch_imgs.append(frame)
                if len(batch_imgs) < B:
                    continue
            if not batch_imgs:
                break
            out_dev = process_batch(batch_imgs)
            streamed += len(batch_imgs)
            if pending is not None:
                flush(pending)
            pending = _HostCopy(out_dev, len(batch_imgs))
            batch_imgs = []
            if frame is None:
                break
        if pending is not None:
            flush(pending)
    finally:
        stream.close()
        written = writer.close()
    return written, streamed, stream.src_fps


def style_frames(args, frames_dir: Path, image_mode: bool, save_map: dict[int, str],
                 device: torch.device):
    """The per-frame loop over the ``frame_*`` files (JAX ``style_frames``):
    per frame, optional ``--inference_res`` downscale, every slot's stylize
    locked back to the frame size, the RGB weighted slot blend, flow EMA
    (DIS at the auto/explicit flow downscale, exact warp), LAB EMA, then the
    motion or uniform blend. A change of frame size resets the temporal
    caches; the first two frames of a video dump slot A's output and the
    input under ``<work_dir>/debug``. A slot that runs out of device memory
    retries at half size, then falls back to the original frame; any other
    error propagates. Returns (written, planned)."""
    from ..ops.color import rgb_to_gray
    from ..ops.resize import resize_bilinear
    from ..temporal.ema import flow_ema_fuse, lab_ema_step, motion_adaptive_blend, uniform_blend
    from . import stylizer as st

    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    models = load_slot_bank(args, device)
    if not models:
        print("[error] no models loaded")
        sys.exit(2)
    num_models = len(models)
    print(f"[bank] {num_models} slot(s): "
          + ", ".join(f"{m.name}({m.arch}/{m.io_preset})" for m in models))
    stylize_fns = [st.jit_stylizer(m, dtype=dtype, quantize=args.quantize) for m in models]
    weights = parse_blend_weights(args.blend_models_weights, num_models)
    frame_files = list_frame_files(args, frames_dir)
    use_lab = args.smooth_lightness or args.smooth_chroma

    def stylize_slot(si, fn, x01):
        try:
            return fn(x01)[0]
        except torch.cuda.OutOfMemoryError as e:
            print(f"[slot][{chr(65 + si)}][ERROR] forward failed ({type(e).__name__}: {e}) "
                  "— retrying at half-size")
        try:
            h2, w2 = max(1, x01.shape[1] // 2), max(1, x01.shape[2] // 2)
            y_small = fn(resize_bilinear(x01, (h2, w2)))[0]
            print(f"[slot][{chr(65 + si)}] retry succeeded at half-size")
            return resize_bilinear(y_small, (x01.shape[1], x01.shape[2]))
        except torch.cuda.OutOfMemoryError as e2:
            print(f"[slot][{chr(65 + si)}][FALLBACK] second attempt failed "
                  f"({type(e2).__name__}: {e2}); using original frame")
            return x01[0]

    prev_gray = prev_styled01 = prev_lab = None
    prev_frame_size = None
    written = 0
    with torch.no_grad():
        for idx, frame_path in enumerate(frame_files, start=1):
            t0 = time.perf_counter()
            u8 = np.array(fio.load_image_exif_rgb(str(frame_path)), np.uint8)
            x_orig = torch.from_numpy(u8).to(device).float() / 255.0
            H0, W0 = x_orig.shape[0], x_orig.shape[1]

            x_src = x_orig
            if args.inference_res and max(H0, W0) > args.inference_res:
                s = args.inference_res / max(H0, W0)
                x_src = resize_bilinear(x_orig, (int(round(H0 * s)), int(round(W0 * s))))
            if prev_frame_size != (H0, W0):  # a new size resets the temporal caches
                prev_gray = prev_styled01 = prev_lab = None
                prev_frame_size = (H0, W0)

            outputs = [stylize_slot(si, fn, x_src[None]) for si, fn in enumerate(stylize_fns)]
            outputs = [o if o.shape[:2] == (H0, W0) else resize_bilinear(o, (H0, W0))
                       for o in outputs]
            if idx <= 2 and not image_mode:
                debug_dir = frames_dir.parent / "debug"
                debug_dir.mkdir(parents=True, exist_ok=True)
                a_u8 = (np.clip(outputs[0].cpu().numpy(), 0, 1) * 255).astype(np.uint8)
                _save(a_u8, debug_dir / f"A_out_{idx:04d}.jpg", True, 92)
                in_u8 = (np.clip(u8.astype(np.float32) / 255.0, 0, 1) * 255).astype(np.uint8)
                _save(in_u8, debug_dir / f"IN_{idx:04d}.jpg", True, 92)
                print(f"[debug] wrote {debug_dir}/A_out_{idx:04d}.jpg and IN_{idx:04d}.jpg")

            if num_models == 1:
                out01 = outputs[0]
            else:
                acc = outputs[0] * weights[0]
                for o, w in zip(outputs[1:], weights[1:]):
                    acc = acc + o * w
                out01 = acc.clamp(0.0, 1.0)

            gray = rgb_to_gray(x_orig * 255.0)
            last_flow = None
            if args.flow_ema and prev_gray is not None and prev_styled01 is not None:
                last_flow = flows_at_downscale(args, prev_gray[None], gray[None])[0]
                out01 = flow_ema_fuse(out01, prev_styled01, last_flow, args.flow_alpha)
            prev_gray, prev_styled01 = gray, out01

            if use_lab:
                out01, prev_lab = lab_ema_step(
                    out01, prev_lab, smooth_alpha=args.smooth_alpha,
                    chroma_alpha=args.chroma_alpha, smooth_lightness=args.smooth_lightness,
                    smooth_chroma=args.smooth_chroma)
            if args.motion_blend and last_flow is not None:
                out01 = motion_adaptive_blend(out01, x_orig, last_flow, args.blend)
            else:
                out01 = uniform_blend(out01, x_orig, args.blend)

            out_u8 = (np.clip(out01.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
            out_path, jpg = _out_path(args, frames_dir, frame_path, idx, image_mode, save_map)
            _save(out_u8, out_path, jpg, args.jpeg_quality)
            written += 1
            if idx == 1 or idx % 10 == 0:
                print(f"[frame][{idx}/{len(frame_files)}] dt={time.perf_counter() - t0:.3f}s "
                      f"-> {out_path.name}")
    return written, len(frame_files)


class _Prefetch:
    """Frames decoded ahead on a thread pool, in order (the port's stand-in
    for the JAX engine's C++ ``NativeFrameLoader``): ``next()`` returns the
    next file's RGB uint8 array, as ``io.frames.load_image_exif_rgb`` loads
    it; ``capacity`` loads are in flight."""

    def __init__(self, files: list[Path], threads: int = 4, capacity: int = 16):
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        self._files = iter(files)
        self._pool = ThreadPoolExecutor(max_workers=threads)
        self._q: deque = deque()
        for _ in range(capacity):
            self._submit()

    def _submit(self):
        f = next(self._files, None)
        if f is not None:
            self._q.append(self._pool.submit(
                lambda p: np.asarray(fio.load_image_exif_rgb(str(p)), np.uint8), f))

    def __next__(self) -> np.ndarray:
        img = self._q.popleft().result()
        self._submit()
        return img

    def close(self):
        self._pool.shutdown(wait=True, cancel_futures=True)


def style_frames_batched(args, frames_dir: Path, image_mode: bool, save_map: dict[int, str],
                         device: torch.device):
    """Device batches over the ``frame_*`` files (JAX ``style_frames_batched``):
    ``make_batched_core`` per batch, the files read ahead by ``_Prefetch``,
    and the previous batch's frames written while the device runs the next.
    Returns (written, planned)."""
    B, process_batch = make_batched_core(args, device)
    frame_files = list_frame_files(args, frames_dir)
    loader = _Prefetch(frame_files, threads=4, capacity=max(8, 2 * B))
    written = 0
    t_start = time.perf_counter()

    def flush(ent: _HostCopy, chunk: list, b0: int):
        nonlocal written
        frames = ent.wait()
        for i in range(ent.n):
            out_path, jpg = _out_path(args, frames_dir, chunk[i], b0 + i + 1, image_mode,
                                      save_map)
            _save(frames[i], out_path, jpg, args.jpeg_quality)
            written += 1
        done = min(b0 + B, len(frame_files))
        print(f"[batch][{done}/{len(frame_files)}] "
              f"{done / max(1e-9, time.perf_counter() - t_start):.1f} frames/s cumulative")

    pending = None
    try:
        for b0 in range(0, len(frame_files), B):
            chunk = frame_files[b0:b0 + B]
            out_dev = process_batch([next(loader) for _ in chunk])
            if pending is not None:
                flush(*pending)
            pending = (_HostCopy(out_dev, len(chunk)), chunk, b0)
        if pending is not None:
            flush(*pending)
    finally:
        loader.close()
    return written, len(frame_files)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.pattern is None:
        args.pattern = f"*.{args.image_ext}"

    image_single = bool(args.input_image) and bool(args.output_image)
    image_batch = bool(args.input_dir) and bool(args.output_dir)
    image_mode = image_single or image_batch
    video_mode = bool(args.input_video) and bool(args.output_video)
    if image_mode and video_mode:
        print("Provide exactly one of: (input_video & output_video) OR (input_image & "
              "output_image) OR (input_dir & output_dir).")
        return 2
    if not (image_mode or video_mode):
        print("Specify (input_video & output_video) OR (input_image & output_image) OR "
              "(input_dir & output_dir).")
        return 2
    if args.model_type != "magenta" and not args.model:
        print("[error] --model is required unless --model_type magenta")
        return 2
    if image_mode:
        if args.motion_blend:
            print("[warn] --motion_blend ignored in image mode.")
            args.motion_blend = False
        if args.flow_ema:
            print("[warn] --flow_ema ignored in image mode.")
            args.flow_ema = False
    check_supported(args)

    # per-job work dirs isolate image jobs; a video job works in --work_dir
    base_work_dir = Path(args.work_dir).resolve()
    work_dir = base_work_dir / f"job_{uuid.uuid4().hex[:8]}" if image_mode else base_work_dir
    if image_mode:
        print(f"[work_dir] Using isolated work directory: {work_dir}")
    frames_dir = work_dir / "frames"
    frames_dir.mkdir(parents=True, exist_ok=True)

    def purge(patterns):
        for pat in patterns:
            for p in frames_dir.glob(pat):
                p.unlink(missing_ok=True)

    styled = ["styled_frame_*.png", "styled_frame_*.jpg", "styled_frame_*.jpeg"]
    if video_mode or image_single:
        purge(["frame_*.png", "frame_*.jpg", "frame_*.jpeg"] + styled)
    else:
        if Path(args.input_dir).resolve() != frames_dir.resolve():
            purge(["frame_*.png", "frame_*.jpg", "frame_*.jpeg"])
        purge(styled)

    use_batched = args.frame_batch > 1
    use_stream = video_mode and use_batched and args.stream != "off"
    save_map: dict[int, str] = {}
    src_fps = None
    if video_mode and use_stream:
        if args.pre_fps and args.fps:
            print(f"[note] --pre_fps set; frames streamed at pre_fps={args.pre_fps}, "
                  f"encoded at fps={args.fps}.")
    elif video_mode:
        if args.pre_fps and args.fps:
            print(f"[note] --pre_fps set; frames extracted at pre_fps={args.pre_fps}, "
                  f"assembled at fps={args.fps}.")
        canvas_wh = None
        if args.canvas:
            cw, ch = args.canvas.lower().split("x")
            canvas_wh = (int(cw), int(ch))
        src_fps = fio.extract_frames(Path(args.input_video).resolve(), frames_dir,
                                     args.pre_fps or args.fps, args.scale, args.image_ext,
                                     args.jpeg_quality, canvas_wh, args.max_frames)
    elif image_single:
        _stage(Path(args.input_image).resolve(), frames_dir / "frame_0001", args)
        save_map[1] = str(Path(args.output_image).resolve())
    else:
        import glob
        import os

        in_files = sorted(glob.glob(os.path.join(args.input_dir, args.pattern)))
        if not in_files:
            print(f"No files matched: {args.input_dir}/{args.pattern}")
            return 2
        Path(args.output_dir).mkdir(parents=True, exist_ok=True)
        for i, f in enumerate(in_files, start=1):
            src = Path(f).resolve()
            _stage(src, frames_dir / f"frame_{i:04d}", args)
            ext = (src.suffix.lower() if args.keep_ext
                   else (".jpg" if args.image_ext == "jpg" else ".png"))
            m = re.match(r"^frame_(\d+)$", src.stem)
            stem = (f"{args.output_prefix}_{m.group(1)}" if m
                    else f"{src.stem}{args.output_suffix or ''}")
            save_map[i] = str((Path(args.output_dir) / f"{stem}{ext}").resolve())

    if use_stream:
        written, planned, _ = style_video_stream(args, device)
    else:
        runner = style_frames_batched if use_batched else style_frames
        written, planned = runner(args, frames_dir, image_mode, save_map, device)
    print(f"[done] wrote {written}/{planned} styled frames")

    if video_mode and not use_stream:
        framerate_in = float(args.pre_fps or args.fps or src_fps or 24)
        fps_out = float(args.fps) if (args.pre_fps and args.fps) else None
        n = fio.assemble_video(frames_dir, Path(args.output_video).resolve(), framerate_in,
                               fps_out)
        print(f"[assemble] {n} frames -> {args.output_video}")
    elif video_mode:
        print(f"[stream] encoded {written} frames -> {args.output_video}")

    if args.clean_frames:
        purge(["frame_*.png", "frame_*.jpg", "frame_*.jpeg", "styled_frame_*.png",
               "styled_frame_*.jpg"])
        print(f"[clean] removed frame files under {frames_dir}")
    if args.clean_work_dir and image_mode:
        import shutil

        shutil.rmtree(work_dir, ignore_errors=True)
        print(f"[clean] removed {work_dir}")
    return 0


def _stage(src: Path, dst_stem: Path, args) -> None:
    """Copy an input image into the work dir as ``dst_stem`` + its suffix,
    EXIF-rotated to RGB (JPEGs re-encoded at ``--jpeg_quality``, at most 95)."""
    pil = fio.load_image_exif_rgb(str(src))
    dst = dst_stem.with_suffix(src.suffix.lower())
    if src.suffix.lower() in (".jpg", ".jpeg"):
        pil.save(dst, format="JPEG", quality=max(1, min(95, args.jpeg_quality)))
    else:
        pil.save(dst)


if __name__ == "__main__":
    sys.exit(main())
