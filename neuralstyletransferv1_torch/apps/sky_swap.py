"""Semantic-segmentation masking tool: DeepLabV3+ masks for images and frame
folders, and the plate composite.

Counterpart of ``neuralstyletransferv1_tpu/apps/sky_swap.py``, on the
port's DeepLab (``models/deeplab.py``). The model loads once and runs on
``--device`` (``cuda`` unless told ``cpu``; no GPU raises); the mask
cleanup (close, dilate, erode, Gaussian feather) runs on the same device.
Run it as ``python -m neuralstyletransferv1_torch.apps.sky_swap``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch
from PIL import Image, ImageOps

from ..device import resolve_device

CITYSCAPES_SKY_ID_DEFAULT = 10

VOC21_LABELS = {
    "background": 0, "aeroplane": 1, "bicycle": 2, "bird": 3, "boat": 4,
    "bottle": 5, "bus": 6, "car": 7, "cat": 8, "chair": 9,
    "cow": 10, "diningtable": 11, "dog": 12, "horse": 13,
    "motorbike": 14, "person": 15, "pottedplant": 16, "sheep": 17,
    "sofa": 18, "train": 19, "tvmonitor": 20,
}

CITYSCAPES19_LABELS = {
    "road": 0, "sidewalk": 1, "building": 2, "wall": 3, "fence": 4,
    "pole": 5, "traffic light": 6, "traffic sign": 7, "vegetation": 8,
    "terrain": 9, "sky": 10, "person": 11, "rider": 12, "car": 13,
    "truck": 14, "bus": 15, "train": 16, "motorcycle": 17, "bicycle": 18,
}

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def canonicalize_label_name(s: str) -> str:
    return s.strip().lower().replace("_", " ").replace("-", " ")


def lookup_label_ids(label_names, used_nc: int):
    """Label names → sorted unique class ids of the VOC (21) or Cityscapes
    (19) table, both merged for other class counts; unknown names warn."""
    if used_nc == 21:
        table = VOC21_LABELS
    elif used_nc == 19:
        table = CITYSCAPES19_LABELS
    else:
        table = {**VOC21_LABELS, **CITYSCAPES19_LABELS}
    ids = []
    for name in label_names:
        key = canonicalize_label_name(name)
        if key in table:
            ids.append(int(table[key]))
        else:
            print(f"[warn] unknown label '{name}' for used_nc={used_nc}; skipping")
    return sorted(set(ids))


def load_deeplab(weights_path: str, backbone: str = "auto", num_classes: int | None = None):
    """Reference-format DeepLab weights (a ``.pth.tar``, optionally under a
    ``state_dict`` key) → (the port's state dict, class count, backbone);
    ``auto`` detects the backbone from the keys."""
    from ..models import deeplab as dl

    ckpt = torch.load(weights_path, map_location="cpu", weights_only=False)
    state = ckpt["state_dict"] if isinstance(ckpt, dict) and "state_dict" in ckpt else ckpt
    if backbone in (None, "auto"):
        backbone = dl.detect_backbone(state)
    params, detected_nc = dl.import_deeplab(state, backbone=backbone)
    nc = num_classes or detected_nc
    print(f"[info] using num_classes={nc} (detected={detected_nc}) backbone={backbone}")
    return params, int(nc), backbone


def _mask_postprocess_np(sky_u8: np.ndarray, expand_px: int, contract_px: int,
                         feather_px: int, morph_close_ks: int = 5,
                         device: torch.device | str = "cpu") -> np.ndarray:
    """Close → dilate → erode → Gaussian feather on ``device``, then clip and
    a truncating cast to uint8, as the JAX function."""
    from ..ops.blur import gaussian_blur
    from ..ops.morphology import grey_dilate, grey_erode, morph_close

    m = torch.from_numpy(sky_u8.astype(np.float32)).to(device)
    if morph_close_ks and morph_close_ks > 0:
        m = morph_close(m, morph_close_ks)
    if int(expand_px) > 0:
        m = grey_dilate(m, int(expand_px) * 2 + 1)
    if int(contract_px) > 0:
        m = grey_erode(m, int(contract_px) * 2 + 1)
    if int(feather_px) > 0:
        m = gaussian_blur(m, float(feather_px) * 0.5)
    return np.clip(m.cpu().numpy(), 0, 255).astype(np.uint8)


class SegmentationModel:
    """DeepLab inference in f32 on ``device`` (``cuda`` or ``cpu``): ImageNet
    normalisation, the forward, the argmax as uint8."""

    def __init__(self, params: dict, num_classes: int, backbone: str = "resnet",
                 device: torch.device | str = "cuda"):
        from ..models.deeplab import DeepLab

        self.device = resolve_device(device) if isinstance(device, str) else device
        self.num_classes = num_classes
        self.backbone = backbone
        self.net = DeepLab(params, backbone=backbone).to(self.device).eval()
        self._mean = torch.tensor(_MEAN, device=self.device)
        self._std = torch.tensor(_STD, device=self.device)

    @torch.no_grad()
    def predict(self, pil_im: Image.Image) -> np.ndarray:
        x01 = torch.from_numpy(np.asarray(pil_im.convert("RGB"), np.float32) / 255.0)
        xin = (x01.to(self.device) - self._mean) / self._std
        logits = self.net(xin[None])
        return logits[0].argmax(-1).to(torch.uint8).cpu().numpy()


def infer_mask(model: SegmentationModel, pil_im, sky_id=CITYSCAPES_SKY_ID_DEFAULT,
               expand_px=0, contract_px=0, feather_px=3, target_ids=None,
               return_pred=False, morph_close_ks=5):
    """The [0, 255] mask of ``target_ids`` (default: ``sky_id``), cleaned up."""
    pred = model.predict(pil_im)
    raw_pred = pred.copy()
    if not target_ids:
        target_ids = [int(sky_id)]
    sky = np.zeros_like(pred, np.uint8)
    for cid in target_ids:
        sky |= (pred == int(cid)).astype(np.uint8)
    sky = (sky * 255).astype(np.uint8)
    sky = _mask_postprocess_np(sky, expand_px, contract_px, feather_px, morph_close_ks,
                               device=model.device)
    if return_pred:
        return sky, raw_pred
    return sky


def guess_sky_id(model: SegmentationModel, pil_im, num_classes, top_frac=0.4):
    """The class with the largest coverage of the top band (ties: full-frame
    coverage, then the higher id)."""
    pred = model.predict(pil_im).astype(np.int32)
    h, w = pred.shape
    top_h = max(1, int(h * float(top_frac)))
    scores = []
    for cid in range(int(num_classes)):
        full = (pred == cid).sum() / float(h * w)
        top = (pred[:top_h, :] == cid).sum() / float(top_h * w)
        scores.append((top, full, cid))
    scores.sort(reverse=True)
    best_top, best_full, best_cid = scores[0]
    print(f"[info] scan_sky: best_id={best_cid} top={best_top:.3f} full={best_full:.3f}")
    return int(best_cid), float(best_top), float(best_full)


def _resize_plate_preserve_ar(plate_pil, target_size, mode="crop"):
    W, H = target_size
    if mode == "crop":
        return ImageOps.fit(plate_pil, (W, H), method=Image.LANCZOS, bleed=0.0, centering=(0.5, 0.5))
    if mode == "pad":
        contained = ImageOps.contain(plate_pil, (W, H), method=Image.LANCZOS)
        canvas = Image.new("RGB", (W, H))
        try:
            edge = contained.getpixel((0, 0))
        except Exception:
            edge = (0, 0, 0)
        canvas.paste(edge, [0, 0, W, H])
        canvas.paste(contained, ((W - contained.width) // 2, (H - contained.height) // 2))
        return canvas
    return plate_pil.resize((W, H), Image.LANCZOS)


def composite(base_pil, plate_pil, mask_u8, fit_mode="crop"):
    """The plate over the base image through the mask (truncating uint8)."""
    base = np.array(base_pil.convert("RGB"))
    plate = np.array(_resize_plate_preserve_ar(plate_pil.convert("RGB"),
                                               (base.shape[1], base.shape[0]), fit_mode))
    alpha = (mask_u8.astype(np.float32) / 255.0)[..., None]
    return Image.fromarray((alpha * plate + (1.0 - alpha) * base).astype(np.uint8))


def _pct_to_px(pct: float, h: int) -> int:
    return max(0, int(round(h * pct / 100.0)))


def _apply_transpose(m: np.ndarray, mode: str) -> np.ndarray:
    if mode == "rot90":
        return np.rot90(m, k=-1).copy()
    if mode == "rot270":
        return np.rot90(m, k=1).copy()
    if mode == "flip_h":
        return m[:, ::-1].copy()
    if mode == "flip_v":
        return m[::-1].copy()
    return m


_PALETTE = None


def _colorize_pred(pred: np.ndarray) -> Image.Image:
    global _PALETTE
    if _PALETTE is None:
        rng = np.random.default_rng(0)
        _PALETTE = rng.integers(0, 255, size=(256, 3), dtype=np.uint8)
    return Image.fromarray(_PALETTE[pred])


def _downscale(img: Image.Image, resolution) -> Image.Image:
    """LANCZOS downscale so the longer side is ``resolution`` (never up)."""
    if resolution and resolution > 0:
        w, h = img.size
        s = float(resolution) / max(w, h)
        if s < 1.0:
            img = img.resize((int(w * s), int(h * s)), Image.LANCZOS)
    return img


def batch_masks_from_frames(frames_dir, out_dir, model: SegmentationModel, sky_id, *,
                            expand_pct=0.0, contract_pct=0.0, feather_pct=0.0,
                            expand_px=0, contract_px=0, feather_px=3,
                            resolution=256, verbose=False, target_ids=None,
                            debug_pred=False, debug_overlay=False,
                            transpose="none", morph_close_ks=5):
    """``mask_<n>.png`` for every ``frame_<n>.{png,jpg,jpeg}`` of ``frames_dir``,
    at the frame's size. A frame that fails is reported and skipped, as the
    reference tool does; the count written is printed."""
    fdir, odir = Path(frames_dir), Path(out_dir)
    odir.mkdir(parents=True, exist_ok=True)
    frames = sorted(
        list(fdir.glob("frame_*.png")) + list(fdir.glob("frame_*.jpg")) + list(fdir.glob("frame_*.jpeg"))
    )
    if verbose:
        print(f"[batch] frames_dir={fdir}  out_dir={odir}  found={len(frames)}")
    if not frames:
        raise FileNotFoundError(f"[batch][error] No frames like frame_*.png/.jpg in {fdir}")
    n_ok = 0
    for fp in frames:
        num = fp.stem.split("_")[-1]
        dst = odir / f"mask_{num}.png"
        try:
            img = Image.open(fp).convert("RGB")
            orig_w, orig_h = img.size
            img = _downscale(img, resolution)
            h2 = img.size[1]
            e_px = _pct_to_px(expand_pct, h2) if expand_pct > 0 else int(expand_px)
            c_px = _pct_to_px(contract_pct, h2) if contract_pct > 0 else int(contract_px)
            f_px = _pct_to_px(feather_pct, h2) if feather_pct > 0 else int(feather_px)
            m, pred = infer_mask(
                model, img, sky_id=sky_id, expand_px=e_px, contract_px=c_px,
                feather_px=f_px, target_ids=target_ids, return_pred=True,
                morph_close_ks=morph_close_ks,
            )
            if m.shape[1] != orig_w or m.shape[0] != orig_h:
                m = np.array(Image.fromarray(m).resize((orig_w, orig_h), Image.BILINEAR), np.uint8)
                pred = np.array(Image.fromarray(pred).resize((orig_w, orig_h), Image.NEAREST), np.uint8)
            if transpose and transpose != "none":
                m = _apply_transpose(m, transpose)
                pred = _apply_transpose(pred, transpose)
            if debug_pred:
                _colorize_pred(pred).resize((orig_w, orig_h), Image.NEAREST).save(odir / f"pred_{num}.png")
            if debug_overlay:
                base = np.array(Image.open(fp).convert("RGB"), np.uint8)
                alpha = (m.astype(np.float32) / 255.0)[:, :, None]
                red = np.zeros_like(base)
                red[..., 0] = 255
                Image.fromarray((alpha * red + (1 - alpha) * base).astype(np.uint8)).save(
                    odir / f"overlay_{num}.jpg", quality=92
                )
            Image.fromarray(m).save(dst)
            n_ok += 1
        except Exception as ex:
            print(f"[batch][warn] failed {fp.name}: {ex}")
    print(f"[batch] wrote {n_ok}/{len(frames)} masks to {odir}")


def build_arg_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--image", required=False)
    ap.add_argument("--weights", required=True)
    ap.add_argument("--backbone",
                    choices=["auto", "resnet", "xception", "drn", "mobilenet"],
                    default="auto", help="auto = detect from the checkpoint")
    ap.add_argument("--sky_id", type=int, default=CITYSCAPES_SKY_ID_DEFAULT)
    ap.add_argument("--num_classes", type=int, default=None)
    ap.add_argument("--scan_sky", action="store_true")
    ap.add_argument("--scan_top_frac", type=float, default=0.4)
    ap.add_argument("--plate")
    ap.add_argument("--plate_fit", choices=["crop", "pad", "stretch"], default="crop")
    ap.add_argument("--out_mask", default="sky_mask.png")
    ap.add_argument("--out_image", default="sky_swapped.jpg")
    ap.add_argument("--device", choices=["cpu", "cuda", "mps", "tpu"], default="cuda",
                    help="cuda (needs a visible GPU) or cpu")
    ap.add_argument("--resolution", type=int, default=256)
    ap.add_argument("--mask_expand", type=int, default=0)
    ap.add_argument("--mask_contract", type=int, default=0)
    ap.add_argument("--mask_feather", type=int, default=3)
    ap.add_argument("--mask_expand_pct", type=float, default=0.0)
    ap.add_argument("--mask_contract_pct", type=float, default=0.0)
    ap.add_argument("--mask_feather_pct", type=float, default=0.0)
    ap.add_argument("--batch_frames", type=str, default=None)
    ap.add_argument("--batch_out_dir", type=str, default=None)
    ap.add_argument("--target_labels", type=str, default=None)
    ap.add_argument("--target_ids", type=str, default=None)
    ap.add_argument("--debug_pred", action="store_true")
    ap.add_argument("--debug_overlay", action="store_true")
    ap.add_argument("--transpose", choices=["none", "rot90", "rot270", "flip_h", "flip_v"], default="none")
    ap.add_argument("--morph_close_ks", type=int, default=5)
    return ap


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    device = resolve_device(args.device)
    params, nc, bb = load_deeplab(args.weights, args.backbone, args.num_classes)
    model = SegmentationModel(params, nc, bb, device=device)

    target_ids = None
    if args.target_ids:
        target_ids = sorted({int(t) for t in args.target_ids.replace("|", ",").split(",") if t.strip()})
    elif args.target_labels:
        target_ids = lookup_label_ids(args.target_labels.replace("|", ",").split(","), nc)

    sky_id = args.sky_id
    if args.batch_frames:
        if args.scan_sky:
            fdir = Path(args.batch_frames)
            frames = sorted(list(fdir.glob("frame_*.png")) + list(fdir.glob("frame_*.jpg")))
            if frames:
                first = _downscale(Image.open(frames[0]).convert("RGB"), args.resolution)
                sky_id, _, _ = guess_sky_id(model, first, nc, args.scan_top_frac)
        out_dir = args.batch_out_dir or str(Path(args.batch_frames).parent / "masks")
        batch_masks_from_frames(
            args.batch_frames, out_dir, model, sky_id,
            expand_pct=args.mask_expand_pct, contract_pct=args.mask_contract_pct,
            feather_pct=args.mask_feather_pct, expand_px=args.mask_expand,
            contract_px=args.mask_contract, feather_px=args.mask_feather,
            resolution=args.resolution, verbose=args.verbose, target_ids=target_ids,
            debug_pred=args.debug_pred, debug_overlay=args.debug_overlay,
            transpose=args.transpose, morph_close_ks=args.morph_close_ks,
        )
        return 0

    if not args.image:
        print("[error] --image is required unless --batch_frames is used")
        return 2
    img = Image.open(args.image).convert("RGB")
    work = _downscale(img, args.resolution)
    if args.scan_sky:
        sky_id, _, _ = guess_sky_id(model, work, nc, args.scan_top_frac)
    h2 = work.size[1]
    e_px = _pct_to_px(args.mask_expand_pct, h2) if args.mask_expand_pct > 0 else args.mask_expand
    c_px = _pct_to_px(args.mask_contract_pct, h2) if args.mask_contract_pct > 0 else args.mask_contract
    f_px = _pct_to_px(args.mask_feather_pct, h2) if args.mask_feather_pct > 0 else args.mask_feather
    m = infer_mask(model, work, sky_id=sky_id, expand_px=e_px, contract_px=c_px,
                   feather_px=f_px, target_ids=target_ids, morph_close_ks=args.morph_close_ks)
    if work.size != img.size:
        m = np.array(Image.fromarray(m).resize(img.size, Image.BILINEAR), np.uint8)
    Image.fromarray(m).save(args.out_mask)
    print(f"[ok] wrote mask: {args.out_mask}")
    if args.plate:
        plate = Image.open(args.plate)
        out = composite(img, plate, m, args.plate_fit)
        out.save(args.out_image, quality=92)
        print(f"[ok] wrote composite: {args.out_image}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
