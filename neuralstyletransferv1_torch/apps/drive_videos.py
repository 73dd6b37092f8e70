"""drive_videos — batch planner + montage assembler over input_videos/.

Counterpart of ``neuralstyletransferv1_tpu/apps/drive_videos.py``, with the
reference planner's behaviour (reference: drive_videos.py):
- explicit ``MODELS="pytorch:candy|torch7:x.t7,…"`` plans with per-video
  deterministic shuffle (sha256 seed, :487-489), MAX_MODELS cap, and the four
  CHUNK_STRATEGY modes chunk/error/clamp4/pad (:498-707)
- the random plan: seed = sha256(video name), shuffled model lists, 2 magenta
  slots + random pth/t7 for the rest (:787-846)
- montage mode: one clip per model/batch, auto segment sizing compensated for
  crossfades (:536-546), sequential trims, then a crossfade chain
- exact equal-weight CSVs via Decimal (:85-99)

Clips render in process through ``run_videos`` and the port's engine (no
subprocess per chunk; ``DEVICE``, ``cuda`` unless told ``cpu``, reaches it
as ``--device``); trims, durations and the montage's crossfade chain use
OpenCV. Across hosts: ``QUEUE_DIR`` (+ ``QUEUE_ROLE`` enqueue / work / both,
``WORKER_ID``, ``QUEUE_STALE_SECS``) claims videos from a shared-filesystem
queue (``parallel/jobqueue.py``); ``NUM_HOSTS`` / ``HOST_ID`` split them
round-robin where no filesystem is shared.

    DEVICE=cpu IN_DIR=videos OUT_DIR=out MODELS=pytorch:/abs/candy.pth \
        python -m neuralstyletransferv1_torch.apps.drive_videos
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import random
from decimal import ROUND_HALF_UP, Decimal, getcontext

IO_PRESETS = {
    "transformer": "imagenet_255",
    "torch7": "caffe_bgr",
    "magenta": "imagenet_01",
    "reconet": "imagenet_01",
}


def parse_models_env(models_str: str):
    """'pytorch:candy,torch7:x.t7' → [{'type','id'}] (reference: :16-29)."""
    models = []
    if not models_str:
        return models
    for raw in (p.strip() for p in models_str.split(",") if p.strip()):
        if ":" in raw:
            kind, ident = raw.split(":", 1)
            models.append({"type": kind.strip().lower(), "id": ident.strip()})
        else:
            models.append({"type": "transformer", "id": raw})
    return models


def parse_models_groups(models_str: str):
    """'a|b,c|d' → batches (reference: :32-44)."""
    if not models_str or "|" not in models_str:
        return []
    return [parse_models_env(g) for g in models_str.split("|") if g.strip()]


def equal_weights_csv(n: int) -> str:
    """Exact-sum weight CSV via Decimal (reference: :85-99)."""
    if n <= 0:
        return ""
    getcontext().prec = 28
    unit = Decimal("1.000000")
    step = (unit / Decimal(n)).quantize(Decimal("0.000001"), rounding=ROUND_HALF_UP)
    weights = [step] * (n - 1)
    weights.append((unit - sum(weights)).quantize(Decimal("0.000001"), rounding=ROUND_HALF_UP))
    return ",".join(f"{w:.6f}" for w in weights)


def probe_duration_seconds(video_path) -> float:
    """frame_count / fps through OpenCV (the reference asks ffprobe,
    :102-114; the port's machines have no ffprobe); 0.0 when unreadable."""
    try:
        import cv2

        cap = cv2.VideoCapture(str(video_path))
        n = cap.get(cv2.CAP_PROP_FRAME_COUNT)
        fps = cap.get(cv2.CAP_PROP_FPS) or 0
        cap.release()
        return float(n / fps) if fps else 0.0
    except Exception:
        return 0.0


def resolve_model_for_slot(m, pytorch_dir, torch_dir, magenta_dir, magenta_styles_dir):
    """(model_value, model_type, magenta_style) (reference: :50-82)."""
    kind = m["type"]
    ident = m["id"]
    if kind in ("pytorch", "transformer"):
        p = pathlib.Path(ident)
        if not p.is_absolute():
            p = pathlib.Path(pytorch_dir) / (ident if p.suffix else f"{ident}.pth")
        return str(p), "transformer", ""
    if kind == "torch7":
        p = pathlib.Path(ident)
        if not p.is_absolute():
            p = pathlib.Path(torch_dir) / (ident if p.suffix else f"{ident}.t7")
        return str(p), "torch7", ""
    if kind == "magenta":
        sp = pathlib.Path(ident)
        if not sp.is_absolute():
            sp = pathlib.Path(magenta_styles_dir) / ident
        return str(magenta_dir), "magenta", str(sp)
    if kind == "reconet":
        return ident, "reconet", ""
    raise ValueError(f"unknown model kind: {kind}")


def chunked(seq, n):
    for i in range(0, len(seq), n):
        yield seq[i : i + n]


def make_style_label(m: dict) -> str:
    base = pathlib.Path(m.get("id", "")).stem or m.get("type", "")
    return f"{m.get('type', '')}-{base}".replace(" ", "_")


def plan_chunks(models, strategy: str):
    """CHUNK_STRATEGY handling (reference: :498-707)."""
    if strategy not in {"chunk", "error", "clamp4", "pad"}:
        strategy = "chunk"
    if len(models) <= 4:
        if strategy == "pad" and models:
            padded = list(models)
            i = 0
            while len(padded) < 4:
                padded.append(models[i % len(models)])
                i += 1
            return [padded]
        return [models]
    if strategy == "error":
        raise SystemExit(f"MODELS has {len(models)} entries (>4) and CHUNK_STRATEGY=error")
    if strategy == "clamp4":
        return [models[:4]]
    return list(chunked(models, 4))


def slot_env_for_chunk(chunk, dirs, blend_weights_override: str = ""):
    """Slot env vars for one ≤4-model chunk (reference: :742-762)."""
    env = {}
    env["BLEND_WEIGHTS"] = blend_weights_override or equal_weights_csv(len(chunk))
    for slot, m in zip(["A", "B", "C", "D"], chunk):
        model_val, model_type, style = resolve_model_for_slot(m, *dirs)
        env[f"MODEL_{slot}"] = model_val
        env[f"MODEL_{slot}_TYPE"] = model_type
        env[f"IO_PRESET_{slot}"] = IO_PRESETS.get(model_type, "imagenet_255")
        if model_type == "magenta":
            env["MAGENTA_STYLE" if slot == "A" else f"MAGENTA_STYLE_{slot}"] = style
    return env


def random_plan(vid_name, pytorch_models, torch_models, magenta_styles, magenta_available, magenta_dir):
    """Deterministic per-video random plan (reference: :787-846)."""
    seed = int(hashlib.sha256(vid_name.encode()).hexdigest(), 16) % (2**32)
    rng = random.Random(seed)
    pm, tm, ms = list(pytorch_models), list(torch_models), list(magenta_styles)
    rng.shuffle(pm)
    rng.shuffle(tm)
    rng.shuffle(ms)
    slots = ["A", "B", "C", "D"]
    magenta_slots = rng.sample(slots, 2)
    rest = [s for s in slots if s not in magenta_slots]
    config = {s: {"model": "", "type": "", "style": ""} for s in slots}
    avail_styles = list(ms)
    if magenta_available:
        for s in magenta_slots:
            if not avail_styles:
                raise SystemExit(f"Not enough unique Magenta styles for slot {s} in video {vid_name}")
            style = rng.choice(avail_styles)
            config[s] = {"model": str(magenta_dir), "type": "magenta", "style": pathlib.Path(style).name}
            avail_styles.remove(style)
    avail = pm + tm
    for s in rest:
        if not avail:
            continue
        model = rng.choice(avail)
        config[s] = {
            "model": str(model),
            "type": "transformer" if pathlib.Path(model).suffix == ".pth" else "torch7",
            "style": "",
        }
        avail.remove(model)
    return config


# ---------------------------------------------------------------------------
# Montage assembly (crossfade chain through OpenCV)
# ---------------------------------------------------------------------------


def crossfade_concat(clip_paths, output_path, fade_secs: float, fps: float | None = None):
    """Concatenate clips with linear crossfades through OpenCV (the reference
    assembles the same chain with ffmpeg xfade, drive_videos.py:321-395)."""
    import cv2
    import numpy as np

    caps = []
    for p in clip_paths:
        cap = cv2.VideoCapture(str(p))
        if not cap.isOpened():
            raise RuntimeError(f"cannot open clip {p}")
        caps.append(cap)
    out_fps = fps or (caps[0].get(cv2.CAP_PROP_FPS) or 24)
    w = int(caps[0].get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(caps[0].get(cv2.CAP_PROP_FRAME_HEIGHT))
    fade_n = max(1, int(round(fade_secs * out_fps)))

    def read_all(cap):
        frames = []
        while True:
            ok, fr = cap.read()
            if not ok:
                break
            if fr.shape[:2] != (h, w):
                fr = cv2.resize(fr, (w, h))
            frames.append(fr)
        cap.release()
        return frames

    clips = [read_all(c) for c in caps]
    clips = [c for c in clips if c]
    if not clips:
        raise RuntimeError("no readable clips for montage")

    timeline = list(clips[0])
    for nxt in clips[1:]:
        k = min(fade_n, len(timeline), len(nxt))
        tail = timeline[-k:] if k else []
        head = nxt[:k]
        blended = [
            (t.astype(np.float32) * (1 - (i + 1) / (k + 1)) + hd.astype(np.float32) * ((i + 1) / (k + 1))).astype(np.uint8)
            for i, (t, hd) in enumerate(zip(tail, head))
        ]
        timeline = timeline[:-k] + blended + nxt[k:]

    for fourcc_name in ("avc1", "mp4v"):
        writer = cv2.VideoWriter(str(output_path), cv2.VideoWriter_fourcc(*fourcc_name), out_fps, (w, h))
        if writer.isOpened():
            break
    for fr in timeline:
        writer.write(fr)
    writer.release()
    return len(timeline)


def trim_video(src, dst, start_secs: float, dur_secs: float):
    """Write a trimmed copy (the reference uses ffmpeg -ss/-t,
    drive_videos.py:183-193)."""
    import cv2

    cap = cv2.VideoCapture(str(src))
    fps = cap.get(cv2.CAP_PROP_FPS) or 24
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    for fourcc_name in ("avc1", "mp4v"):
        writer = cv2.VideoWriter(str(dst), cv2.VideoWriter_fourcc(*fourcc_name), fps, (w, h))
        if writer.isOpened():
            break
    start_f = int(round(start_secs * fps))
    n_f = int(round(dur_secs * fps))
    i = written = 0
    while written < n_f:
        ok, fr = cap.read()
        if not ok:
            break
        if i >= start_f:
            writer.write(fr)
            written += 1
        i += 1
    cap.release()
    writer.release()
    return written


# ---------------------------------------------------------------------------
# The per-video loop
# ---------------------------------------------------------------------------


def _run_chunk(vid, env_overrides: dict):
    """Render one chunk in-process through the run_videos adapter."""
    from . import run_videos as rv

    saved = {}
    try:
        for k, v in env_overrides.items():
            saved[k] = os.environ.get(k)
            os.environ[k] = str(v)
        return rv.main([str(vid)])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def main(argv=None) -> int:
    from ..device import resolve_device

    resolve_device(os.getenv("DEVICE") or "cuda")  # no GPU with DEVICE=cuda raises here
    in_dir = os.getenv("IN_DIR", "/app/input_videos")
    out_dir = os.getenv("OUT_DIR", "/app/output")
    pytorch_dir = os.getenv("PYTORCH_DIR", "/app/models/pytorch")
    torch_dir = os.getenv("TORCH_DIR", "/app/models/torch")
    magenta_dir = os.getenv("MAGENTA_DIR", "/app/models/magenta")
    magenta_styles_dir = os.getenv("MAGENTA_STYLES_DIR", "/app/models/magenta_styles")
    dirs = (pytorch_dir, torch_dir, magenta_dir, magenta_styles_dir)
    pathlib.Path(out_dir).mkdir(parents=True, exist_ok=True)

    pytorch_models = sorted(pathlib.Path(pytorch_dir).glob("*.pth"))
    torch_models = sorted(pathlib.Path(torch_dir).glob("*.t7"))
    magenta_styles = sorted(pathlib.Path(magenta_styles_dir).glob("*.jpg"))
    magenta_available = any(d.is_dir() for d in pathlib.Path(magenta_dir).glob("*")) if pathlib.Path(magenta_dir).exists() else False

    vids = sorted(
        list(pathlib.Path(in_dir).glob("*.mp4")) + list(pathlib.Path(in_dir).glob("*.mov"))
    )
    if not vids:
        print(f"[drive] no videos in {in_dir}")
        return 0

    ctx = (dirs, out_dir, pytorch_models, torch_models, magenta_styles,
           magenta_available, magenta_dir)

    # ---- multi-host work sharding (the reference is single-host serial,
    # drive_videos.py:918) ----
    queue_dir = os.getenv("QUEUE_DIR", "").strip()
    if queue_dir:
        # Dynamic per-video claiming over a shared filesystem: run this SAME
        # command on every host with the same QUEUE_DIR. Enqueue is
        # idempotent (job id = video name), claiming is atomic-rename.
        from ..parallel.jobqueue import JobQueue, default_worker_id

        q = JobQueue(queue_dir)
        role = os.getenv("QUEUE_ROLE", "both").lower()
        if role in ("enqueue", "both"):
            added = sum(q.enqueue_unique({"video": str(v)}, job_id=v.stem)
                        for v in vids)
            print(f"[drive] queue {queue_dir}: enqueued {added} new / "
                  f"{len(vids)} videos ({q.counts()})")
        if role in ("work", "both"):
            worker = os.getenv("WORKER_ID", "") or default_worker_id()

            def _job(rec):
                _process_video(pathlib.Path(rec["video"]), ctx)
                return {}

            n = q.work(_job, worker=worker,
                       stale_secs=float(os.getenv("QUEUE_STALE_SECS", "1800")))
            print(f"[drive] worker {worker} processed {n} video(s); "
                  f"queue now {q.counts()}")
        return 0

    num_hosts = int(os.getenv("NUM_HOSTS", "1") or 1)
    if num_hosts > 1:
        # Static round-robin for hosts with no shared filesystem.
        from ..parallel.jobqueue import shard_static

        host_id = int(os.getenv("HOST_ID", "0") or 0)
        vids = shard_static(vids, host_id, num_hosts)
        print(f"[drive] host {host_id}/{num_hosts}: {len(vids)} video(s)")

    for vid in vids:
        _process_video(vid, ctx)
    return 0


def _process_video(vid, ctx) -> None:
    """Plan + render ONE video (the reference's per-video loop body,
    drive_videos.py:918-1010) — the work unit for multi-host sharding."""
    (dirs, out_dir, pytorch_models, torch_models, magenta_styles,
     magenta_available, magenta_dir) = ctx
    if True:  # keep the original loop body's indentation
        models_env = os.getenv("MODELS", "").strip()
        if models_env:
            models = parse_models_env(models_env)
            if os.getenv("SHUFFLE_MODELS", "0").lower() in {"1", "true", "yes", "on"}:
                seed = int(hashlib.sha256((vid.name + "::models").encode()).hexdigest(), 16) % (2**32)
                random.Random(seed).shuffle(models)
            max_models = int(os.getenv("MAX_MODELS", "0") or 0)
            if max_models > 0:
                models = models[:max_models]
            if not models:
                raise SystemExit("MODELS was set but empty after filtering")

            if os.getenv("MONTAGE", "0").lower() in {"1", "true", "yes", "on"}:
                _montage(vid, models, models_env, dirs, out_dir)
                return

            strategy = os.getenv("CHUNK_STRATEGY", "chunk").lower()
            chunks = plan_chunks(models, strategy)
            multi = len(chunks) > 1
            for idx, ch in enumerate(chunks, start=1):
                env = slot_env_for_chunk(ch, dirs, os.getenv("BLEND_WEIGHTS", "").strip())
                if multi:
                    env["OUTPUT_SUFFIX"] = f"_set{idx:02d}"
                print(f"[plan] {vid.name}: chunk {idx}/{len(chunks)} uses {len(ch)} model(s), "
                      f"BLEND_WEIGHTS={env['BLEND_WEIGHTS']}")
                try:
                    _run_chunk(vid, env)
                except Exception as e:  # keep going per-video like the reference
                    print(f"[error] Video {vid.name}: chunk {idx} failed: {e}")
            return

        # Random plan path
        config = random_plan(vid.name, pytorch_models, torch_models, magenta_styles,
                             magenta_available, magenta_dir)
        env = {}
        active = [s for s in ["A", "B", "C", "D"] if config[s]["model"]]
        env["BLEND_WEIGHTS"] = equal_weights_csv(len(active))
        for s in active:
            env[f"MODEL_{s}"] = config[s]["model"]
            env[f"MODEL_{s}_TYPE"] = config[s]["type"]
            env[f"IO_PRESET_{s}"] = IO_PRESETS.get(config[s]["type"], "imagenet_255")
            if config[s]["type"] == "magenta":
                env["MAGENTA_STYLE" if s == "A" else f"MAGENTA_STYLE_{s}"] = config[s]["style"]
        print(f"[plan] {vid.name}: random plan {[config[s]['type'] for s in active]}")
        try:
            _run_chunk(vid, env)
        except Exception as e:
            print(f"[error] Video {vid.name}: {e}")


def _montage(vid, models, models_env, dirs, out_dir):
    """Montage mode (reference: drive_videos.py:536-707)."""
    import tempfile

    explicit_batches = parse_models_groups(models_env)
    seg_secs = float(os.getenv("SEGMENT_SECS", "2"))
    fade_secs = float(os.getenv("FADE_SECS", "0.5"))
    intro_secs = float(os.getenv("INTRO_SECS", "1"))
    batch_size = max(1, int(os.getenv("MONTAGE_BATCH_SIZE", "4")))

    if explicit_batches:
        batches = explicit_batches
    elif batch_size == 1:
        batches = [[m] for m in models]
    else:
        batches = list(chunked(models, min(4, batch_size)))
    N = len(batches)

    src_dur = probe_duration_seconds(vid)
    auto_seg = os.getenv("AUTO_SEGMENT", "1").lower() in {"1", "true", "yes", "on"}
    if auto_seg and N > 0:
        remaining = max(0.0, src_dur - intro_secs)
        seg_secs = max(remaining / float(N) + fade_secs, max(0.1, fade_secs))
        print(f"[montage] AUTO_SEGMENT: src_dur={src_dur:.3f}s N={N} → seg_secs={seg_secs:.3f}s")

    layout = os.getenv("MONTAGE_LAYOUT", "sequential").lower()
    with tempfile.TemporaryDirectory(prefix="montage_") as td:
        td = pathlib.Path(td)
        clips = []
        # intro: unstyled head of the source
        intro_clip = td / "intro.mp4"
        if intro_secs > 0 and trim_video(vid, intro_clip, 0.0, intro_secs) > 0:
            clips.append(intro_clip)
        for bi, batch in enumerate(batches):
            if layout == "spread" and src_dur > 0:
                start = intro_secs + bi * max(0.0, (src_dur - intro_secs - seg_secs)) / max(1, N - 1)
            else:
                start = intro_secs + bi * seg_secs
            start = min(start, max(0.0, src_dur - seg_secs))
            trimmed = td / f"trim_{bi:02d}.mp4"
            if trim_video(vid, trimmed, start, seg_secs) == 0:
                print(f"[montage][warn] empty trim for batch {bi}; skipping")
                continue
            env = slot_env_for_chunk(batch, dirs, os.getenv("BLEND_WEIGHTS", "").strip())
            env["OUT_DIR"] = str(td)
            label = "_".join(make_style_label(m) for m in batch)[:60]
            env["OUTPUT_SUFFIX"] = f"_clip{bi:02d}_{label}"
            rc = _run_chunk(trimmed, env)
            rendered = td / f"{trimmed.stem}{env['OUTPUT_SUFFIX']}.mp4"
            if rc == 0 and rendered.exists():
                clips.append(rendered)
            else:
                print(f"[montage][warn] clip {bi} failed (rc={rc})")
        if not clips:
            print(f"[montage][error] no clips rendered for {vid.name}")
            return
        outp = pathlib.Path(out_dir) / f"{vid.stem}_montage.mp4"
        n = crossfade_concat(clips, outp, fade_secs)
        print(f"[montage] wrote {outp} ({n} frames, {len(clips)} clips)")


if __name__ == "__main__":
    import sys

    sys.exit(main())
