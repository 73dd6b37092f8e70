"""The video engine: decode → stylize → DIS flow → temporal chain → encode.

Counterpart of the batched streaming path of ``neuralstyletransferv1_tpu/
engine/pipeline.py`` (``_make_batched_core`` + ``style_video_stream``), with
the same CLI surface (``engine/config.build_arg_parser``, a copy of the
JAX engine's). Frames cross to
the device as uint8 and convert there; the temporal state stays on the
device between batches; the previous batch's frames are copied back and
encoded while the device works on the next batch.

Flags outside this path raise ``NotImplementedError`` naming the ROADMAP.md
item that ports them; none is silently ignored.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from .config import build_arg_parser

_LETTERS = "abcdefgh"

# ROADMAP.md "Queue 1 — port slices" items that port each unsupported mode.
_PER_FRAME = "ROADMAP.md Queue 1, item 2 (per-frame path, image modes, --stream off)"
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
        (args.frame_batch <= 1, "--frame_batch 1 (the per-frame loop)", _PER_FRAME),
        (args.stream == "off", "--stream off", _PER_FRAME),
        (bool(args.region_mode or args.region_optimize), "--region_* modes", _REGIONS),
        (bool(args.mask or args.mask_dir), "--mask / --mask_dir", _REGIONS),
        (args.blend_models_lab, "--blend_models_lab", _REGIONS),
        (args.quantize != "none" and args.compute_dtype != "bfloat16",
         f"--quantize {args.quantize} with --compute_dtype {args.compute_dtype}", _QUANT_F32),
        (int(args.mesh_devices or 0) > 1, "--mesh_devices > 1", _MULTI),
        (args.flow_method != "dis", f"--flow_method {args.flow_method}", _BACKENDS),
        (bool(args.profile_dir), "--profile_dir", _BENCH),
        (bool(args.inference_res), "--inference_res", _PER_FRAME),
    ]
    for path, model_type, _preset, magenta_style in _slot_args(args):
        other = path and (model_type != "transformer" or Path(path).suffix.lower() == ".t7")
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
    """The Johnson checkpoints of slots A..H, on ``device``."""
    from . import stylizer as st

    return [st.load_model(path, io_preset=io_preset, device=device)
            for path, _type, io_preset, _style in _slot_args(args) if path]


def make_batched_core(args, device: torch.device, *, fused_sites=None):
    """The per-batch pipeline: slot-bank stylize → RGB slot blend → DIS flow
    → temporal chain, uint8 in and out. ``fused_sites``: the fused-site set
    (``jit_stylizer``): None is the adopted one in the int8 modes and no
    fused site otherwise; ``head``, ``tail`` and ``d3`` name the bf16 sites.

    Returns (B, process_batch) where ``process_batch(imgs: list[np.uint8
    HWC]) -> device uint8 [B,H,W,3]``; the temporal state carries across
    calls.
    """
    from ..ops.color import rgb_to_gray
    from ..ops.dis_flow import dis_flow
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
    carry = {"state": None, "prev_gray": None}

    def flows_for(prevs, grays):
        """Flow t-1 → t for every frame of the batch, at the auto/explicit
        flow resolution, scaled back to the frame size."""
        H, W = grays.shape[1], grays.shape[2]
        ds = effective_flow_downscale(int(args.flow_downscale), H, W)
        if ds <= 1:
            return dis_flow(prevs, grays)
        hs, ws = H // ds, W // ds
        f_small = dis_flow(resize_bilinear(prevs[..., None], (hs, ws))[..., 0],
                           resize_bilinear(grays[..., None], (hs, ws))[..., 0])
        return resize_bilinear(f_small, (H, W)) * float(ds)

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

        outs = [fn(orig) for fn in stylize_fns]
        styled = (w_slots * torch.stack(outs, 0)).sum(dim=0).clamp(0.0, 1.0)

        if carry["state"] is None:  # first batch: frame 0 is its own predecessor
            carry["prev_gray"] = grays[0]
        flows = None
        if args.flow_ema:
            prevs = torch.cat([carry["prev_gray"][None], grays[:-1]], 0)
            flows = flows_for(prevs, grays)
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
    from ..io import frames as fio

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


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    image_mode = bool(args.input_image or args.input_dir)
    video_mode = bool(args.input_video) and bool(args.output_video)
    if image_mode:
        raise NotImplementedError(f"image modes are not ported to PyTorch yet: {_PER_FRAME}")
    if not video_mode:
        print("Specify --input_video and --output_video.")
        return 2
    check_supported(args)
    if not args.model:
        print("[error] --model is required")
        return 2
    if args.pre_fps and args.fps:
        print(f"[note] --pre_fps set; frames streamed at pre_fps={args.pre_fps}, "
              f"encoded at fps={args.fps}.")
    # the streaming path writes no frame files, so --work_dir and
    # --clean_frames have nothing to act on
    written, planned, _src_fps = style_video_stream(args, device)
    print(f"[done] wrote {written}/{planned} styled frames")
    print(f"[stream] encoded {written} frames -> {args.output_video}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
