"""Output / visualization layer (host side).

The port's copy of the JAX package's ``visualizer.py``: prefix-counted
PNG/NPY writers on one asynchronous writer thread, HSV flow colorization
(DSEC-style ``ord=0.5`` magnitude) in float64 or from the polar planes the
render bundle makes on the device, event images, masked / overlay /
pred-gt views, the Poisson view, incremental and PNG-rebuilt videos, and
the loss-history plots.  ``cv2``, ``PIL`` and ``matplotlib`` are imported
inside the methods that use them.

The device work of a :class:`Visualizer` (the Poisson view, the event
mask when none is given) runs on its ``device`` (the GPU unless the
caller asks for another); only uint8 and bool planes come to the host.

One deliberate divergence from the JAX class: where ``matplotlib`` cannot
be imported, :meth:`Visualizer.visualize_scipy_history`,
:meth:`Visualizer.visualize_plt_figure` and
:meth:`Visualizer.visualize_optuna_history` log one warning per
Visualizer and write nothing, as :func:`utils.video.write_video` does
when no mp4 codec exists.  The JAX class fails on its writer thread there
and :meth:`Visualizer.flush` re-raises it.
"""

from __future__ import annotations

import glob
import logging
import os
import queue
import re
import threading
from typing import Any, List, Optional

import numpy as np
import torch

from .device import resolve_device
from .ops.poisson import poisson_view
from .utils.video import concat_videos_horizontally, write_video


def _poisson_view(grady, gradx, device) -> np.ndarray:
    """The uint8 Poisson view of the gradient pair on ``device``: one
    float32 upload of each plane, one uint8 fetch (values in [1, 255] by
    construction)."""
    flow = torch.stack([torch.as_tensor(np.asarray(a)).to(
        device=device, dtype=torch.float32) for a in (gradx, grady)])
    return poisson_view(flow).cpu().numpy()


logger = logging.getLogger(__name__)


def _to_numpy(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class Visualizer:
    """Prefix-counted image/array writer.

    Files are ``{save_dir}/{prefix}{count}.png`` with an independent
    counter per prefix.  ``device`` is where the Poisson view and the
    fallback event mask are computed.
    """

    def __init__(self, image_shape, show: bool = False, save: bool = True,
                 save_dir: Optional[str] = None, async_writes: bool = False,
                 device=None):
        self.device = resolve_device(device)
        self._image_size = tuple(image_shape)
        self._show = show
        self._save = save
        self.async_writes = async_writes
        self.default_prefix = "image"
        self.default_save_count = 0
        self.prefixed_save_count: dict = {}
        self._frame_index_override: Optional[int] = None
        self.save_dir = save_dir or "."
        if save:
            os.makedirs(self.save_dir, exist_ok=True)
        # single background writer: PNG encodes (cv2 releases the GIL) and
        # the matplotlib history render run off the finalize path, so the
        # evaluation loop can queue the next solve while the previous
        # frame's artifacts are still encoding.  ONE worker keeps writes
        # FIFO (deterministic artifact order) and caps memory with a
        # bounded queue.
        self._write_queue: "queue.Queue" = queue.Queue(maxsize=16)
        self._writer_thread: Optional[threading.Thread] = None
        self._writer_error: Optional[BaseException] = None
        self._hist_state: dict = {}  # persistent history figures (worker-owned)
        # incremental video assembly: prefixes registered via
        # enable_video_stream get their frames appended to a cv2.VideoWriter
        # on the writer thread AS THEY ARE PRODUCED, so the end-of-run
        # "make video" step is a writer release instead of a full PNG
        # re-read+re-encode pass
        self.video_fps = 20.0
        self._video_streams: dict = {}   # prefix -> stream state (worker-owned)
        self._video_pending_cap = 64     # reorder buffer before giving up
        self._matplotlib: Optional[bool] = None  # importable? (checked once)

    # -- async writer ----------------------------------------------------------
    def _enqueue(self, fn) -> None:
        """Queue ``fn`` on the writer thread (started lazily).

        Synchronous unless ``async_writes`` is set (the evaluation loop
        sets it; direct API users keep the call→file-on-disk contract)."""
        if not self.async_writes:
            fn()
            return
        if self._writer_thread is None or not self._writer_thread.is_alive():
            def _drain():
                while True:
                    job = self._write_queue.get()
                    try:
                        if job is None:
                            return
                        job()
                    except BaseException as e:  # surfaced at next flush()
                        logger.exception("async artifact write failed")
                        self._writer_error = e
                    finally:
                        self._write_queue.task_done()

            self._writer_thread = threading.Thread(
                target=_drain, name="viz-writer", daemon=True)
            self._writer_thread.start()
        self._write_queue.put(fn)

    def flush(self) -> None:
        """Block until every queued artifact write hit disk.

        Called before anything reads artifacts back (video assembly) and at
        the end of a run; re-raises the first writer-thread failure."""
        if self._writer_thread is not None:
            self._write_queue.join()
        if self._writer_error is not None:
            err, self._writer_error = self._writer_error, None
            raise RuntimeError("async artifact write failed") from err

    # -- incremental video streams ----------------------------------------------
    def enable_video_stream(self, prefix: str) -> None:
        """Append this prefix's future frames to ``{prefix}.mp4``
        incrementally (on the writer thread) as they are written.

        Must be called before the prefix's first frame (the solver facade
        registers its video prefixes up front); a stream that turns out
        incomplete at finalize time — frames written before enabling,
        resumed runs whose earlier frames exist only as PNGs on disk, or
        an out-of-order gap beyond the reorder buffer — is dropped and
        :meth:`visualize_sequential_images_as_video` falls back to the
        PNG re-read path, so streaming is a pure fast path, never a
        correctness dependency."""
        if prefix not in self._video_streams:
            self._video_streams[prefix] = {
                "writer": None, "size": None, "next": 0, "pending": {},
                "dead": False,
                "path": os.path.join(self.save_dir, f"{prefix}.mp4"),
            }

    def _stream_frame(self, prefix: str, index: int, bgr: np.ndarray) -> None:
        """Writer-thread half of the incremental assembly: buffer the frame
        and drain every in-order frame into the prefix's VideoWriter."""
        import cv2

        st = self._video_streams.get(prefix)
        if st is None or st["dead"]:
            return
        if index < st["next"] or len(st["pending"]) >= self._video_pending_cap:
            # a past index cannot be re-encoded (mp4 is append-only), and an
            # unbounded reorder buffer would hide a leak — drop to fallback
            st["dead"] = True
            if st["writer"] is not None:
                st["writer"].release()
                st["writer"] = None
            st["pending"].clear()
            return
        if bgr.ndim == 2:
            # match what the fallback's cv2.imread returns for a gray PNG
            bgr = cv2.cvtColor(bgr, cv2.COLOR_GRAY2BGR)
        st["pending"][index] = bgr
        while st["next"] in st["pending"]:
            frame = st["pending"].pop(st["next"])
            if st["writer"] is None:
                h, w = frame.shape[:2]
                st["size"] = (h, w)
                st["writer"] = cv2.VideoWriter(
                    st["path"], cv2.VideoWriter_fourcc(*"mp4v"),
                    self.video_fps, (w, h))
                if not st["writer"].isOpened():
                    st["writer"] = None
                    st["dead"] = True
                    st["pending"].clear()
                    return
            if frame.shape[:2] != st["size"]:
                h, w = st["size"]
                frame = cv2.resize(frame, (w, h))
            st["writer"].write(frame)
            st["next"] += 1

    # -- filename bookkeeping -------------------------------------------------
    def update_save_dir(self, new_dir: str) -> None:
        self.save_dir = new_dir
        os.makedirs(new_dir, exist_ok=True)

    def set_frame_index(self, index: Optional[int]) -> None:
        """Pin prefixed filenames to an explicit frame index.

        Per-prefix *call order* equals the frame index only when every
        frame finalizes exactly once, in time order.  The CLI pins the
        index per finalize so artifact names stay aligned with the frame
        numbers in the error texts when frames are skipped (resume).
        ``None`` restores call-order counting."""
        self._frame_index_override = index

    def get_filename_from_prefix(self, prefix: Optional[str] = None,
                                 file_format: str = "png") -> str:
        if not prefix:
            name = f"{self.default_prefix}{self.default_save_count}.{file_format}"
            self.default_save_count += 1
        else:
            self.prefixed_save_count[prefix] = (
                self.prefixed_save_count.get(prefix, -1) + 1
                if self._frame_index_override is None
                else self._frame_index_override)
            name = f"{prefix}{self.prefixed_save_count[prefix]}.{file_format}"
        return os.path.join(self.save_dir, name)

    def rollback_save_count(self, prefix: Optional[str] = None):
        if not prefix:
            self.default_save_count -= 1
        else:
            self.prefixed_save_count[prefix] -= 1

    def reset_save_count(self, file_prefix: Optional[str] = None):
        if not file_prefix:
            self.default_save_count = 0
        elif file_prefix == "all":
            self.default_save_count = 0
            self.prefixed_save_count = {}
        else:
            self.prefixed_save_count.pop(file_prefix, None)

    def _show_or_save_image(self, image, file_prefix=None, fixed_file_name=None):
        import cv2
        from PIL import Image

        arr = image if isinstance(image, np.ndarray) else np.asarray(image)
        if isinstance(image, np.ndarray):
            image = Image.fromarray(image)
        if self._save:
            if fixed_file_name is not None:
                fname = os.path.join(self.save_dir, f"{fixed_file_name}.png")
            else:
                fname = self.get_filename_from_prefix(file_prefix)
            # cv2's PNG encoder is faster than PIL's — same lossless
            # pixels, different file bytes.  cv2 expects BGR(A) order; PIL mode "1"/"P" images
            # don't map to a cv2 array, keep PIL for those.  The encode
            # itself runs on the writer thread (callers hand over freshly
            # built arrays, never mutated afterwards); filenames were
            # already fixed synchronously above, so counters stay exact.
            stream = None
            if (file_prefix is not None and fixed_file_name is None
                    and file_prefix in self._video_streams):
                stream = (file_prefix, self.prefixed_save_count[file_prefix])
            if arr.dtype == np.uint8 and arr.ndim in (2, 3) and (
                    arr.ndim == 2 or arr.shape[2] in (3, 4)):
                if arr.ndim == 3:
                    code = (cv2.COLOR_RGB2BGR if arr.shape[2] == 3
                            else cv2.COLOR_RGBA2BGRA)
                    arr = cv2.cvtColor(arr, code)

                def _job(a=arr, f=fname, s=stream):
                    cv2.imwrite(f, a)
                    if s is not None:
                        # BGRA streams through its PNG round trip below —
                        # cv2.imread drops alpha the same way for both paths
                        self._stream_frame(
                            s[0], s[1],
                            a if a.ndim == 2 or a.shape[2] == 3
                            else cv2.cvtColor(a, cv2.COLOR_BGRA2BGR))

                self._enqueue(_job)
            else:

                def _pil_job(im=image, f=fname, s=stream):
                    im.save(f)
                    if s is not None:
                        # match cv2.imread of the saved PNG: RGB→BGR
                        self._stream_frame(
                            s[0], s[1],
                            np.asarray(im.convert("RGB"))[..., ::-1].copy())

                self._enqueue(_pil_job)
        if self._show:
            image.show()
        return image

    def _save_image_deferred(self, render, file_prefix=None,
                             fixed_file_name=None):
        """Defer an artifact's *rendering* (not just its PNG encode) to the
        writer thread: filename/stream bookkeeping stays synchronous so
        counters and frame-index pinning are exact, while the pixel math
        (colorization, masking, composites) runs off the evaluation loop's
        critical path, while the loop waits for the next solve.

        ``render()`` must be self-contained (capture arrays by value, no
        reads of mutable ``Visualizer`` state) and return a uint8 numpy
        array (gray/RGB/RGBA) or a PIL image convertible to one.  Falls
        back to the eager path when showing or not saving (callers then
        need the returned image)."""
        if self._show or not self._save:
            return self._show_or_save_image(render(), file_prefix,
                                            fixed_file_name)
        if fixed_file_name is not None:
            fname = os.path.join(self.save_dir, f"{fixed_file_name}.png")
            stream = None
        else:
            fname = self.get_filename_from_prefix(file_prefix)
            stream = ((file_prefix, self.prefixed_save_count[file_prefix])
                      if file_prefix is not None
                      and file_prefix in self._video_streams else None)

        def _job(r=render, f=fname, s=stream):
            import cv2

            arr = r()
            if not isinstance(arr, np.ndarray):
                arr = np.asarray(arr.convert("RGB")
                                 if getattr(arr, "mode", None)
                                 not in (None, "L", "RGB", "RGBA") else arr)
            if arr.ndim == 3:
                arr = cv2.cvtColor(arr, cv2.COLOR_RGB2BGR if arr.shape[2] == 3
                                   else cv2.COLOR_RGBA2BGRA)
            cv2.imwrite(f, arr)
            if s is not None:
                self._stream_frame(
                    s[0], s[1],
                    arr if arr.ndim == 2 or arr.shape[2] == 3
                    else cv2.cvtColor(arr, cv2.COLOR_BGRA2BGR))

        self._enqueue(_job)
        return None

    # -- plain images -----------------------------------------------------------
    def visualize_image(self, image: Any, file_prefix: Optional[str] = None):
        arr = _to_numpy(image)
        if arr.dtype != np.uint8:
            arr = np.clip(arr, 0, 255).astype(np.uint8)
        return self._show_or_save_image(arr, file_prefix)

    # -- optical flow -------------------------------------------------------------
    def color_optical_flow(self, flow_x, flow_y, max_magnitude=None, ord=1.0):
        """HSV flow colorization in float64: hue = angle, value =
        magnitude**ord scaled to the max."""
        import cv2

        flow_x = _to_numpy(flow_x).astype(np.float64)
        flow_y = _to_numpy(flow_y).astype(np.float64)
        flows = np.stack((flow_x, flow_y), axis=2)
        flows[~np.isfinite(flows)] = 0
        mag = np.linalg.norm(flows, axis=2) ** ord
        # angle from the finite-zeroed copy too: NaN here would cast to an
        # undefined hue (the pixel is black either way since its V is 0)
        ang = ((np.arctan2(flows[..., 1], flows[..., 0]) + np.pi)
               * 180.0 / np.pi / 2.0)
        hsv = np.zeros(flow_x.shape + (3,), np.uint8)
        hsv[..., 0] = ang.astype(np.uint8)
        hsv[..., 1] = 255
        if max_magnitude is None:
            max_magnitude = mag.max() if mag.max() > 0 else 1.0
        hsv[..., 2] = np.clip(255 * mag / max_magnitude, 0, 255).astype(np.uint8)
        flow_rgb = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)

        n = flow_x.shape[0]
        xx, yy = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n))
        wmag = np.sqrt(xx**2 + yy**2)
        whsv = np.zeros((n, n, 3), np.uint8)
        whsv[..., 0] = ((np.arctan2(yy, xx) + np.pi) * 180 / np.pi / 2.0).astype(np.uint8)
        whsv[..., 1] = 255
        whsv[..., 2] = (255 * wmag / wmag.max()).astype(np.uint8)
        color_wheel = cv2.cvtColor(whsv, cv2.COLOR_HSV2RGB)
        return flow_rgb, color_wheel, max_magnitude

    def _color_wheel(self, n: int):
        """The (flow-independent) HSV color wheel for an ``n``-row flow —
        cached per size, since the per-frame loop re-saves the identical
        wheel under a fixed name."""
        import cv2

        wheel = getattr(self, "_wheel_cache", {}).get(n)
        if wheel is None:
            xx, yy = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n))
            wmag = np.sqrt(xx**2 + yy**2)
            whsv = np.zeros((n, n, 3), np.uint8)
            whsv[..., 0] = ((np.arctan2(yy, xx) + np.pi)
                            * 180 / np.pi / 2.0).astype(np.uint8)
            whsv[..., 1] = 255
            whsv[..., 2] = (255 * wmag / wmag.max()).astype(np.uint8)
            wheel = cv2.cvtColor(whsv, cv2.COLOR_HSV2RGB)
            if not hasattr(self, "_wheel_cache"):
                self._wheel_cache = {}
            self._wheel_cache[n] = wheel
        return wheel

    def color_optical_flow_from_polar(self, ang_u8, magp, max_magnitude=None):
        """HSV flow colorization from device-precomputed polar planes.

        ``ang_u8``: the OpenCV hue plane (uint8, ``(atan2+π)·90/π``
        truncated) and ``magp``: ``‖flow‖**ord`` — both rendered on device
        inside the per-frame bundle (``solver.programs.render_bundle``),
        leaving only the value-plane scaling, the SIMD ``cv2.cvtColor``,
        and the PNG encode on the host.  Pixel-equivalent to
        :meth:`color_optical_flow` up to float32-vs-float64 rounding at
        uint8 quantization boundaries (≤ 1 LSB).
        """
        import cv2

        magp = np.asarray(magp, np.float32)
        if max_magnitude is None:
            mx = float(magp.max())
            max_magnitude = mx if mx > 0 else 1.0
        hsv = np.zeros(magp.shape + (3,), np.uint8)
        hsv[..., 0] = np.asarray(ang_u8)
        hsv[..., 1] = 255
        hsv[..., 2] = np.clip(255.0 * magp / max_magnitude, 0,
                              255).astype(np.uint8)
        return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB), max_magnitude

    def visualize_optical_flow(self, flow_x, flow_y, visualize_color_wheel=True,
                               file_prefix=None, save_flow=False, ord=0.5,
                               polar=None):
        """Colorized flow PNG (and the ``.npy`` flow when ``save_flow``).

        ``polar`` optionally supplies the device-rendered ``(ang_u8, magp)``
        planes (see :meth:`color_optical_flow_from_polar`); the host-side
        float64 colorization runs otherwise.
        """
        from PIL import Image

        # flow_x/flow_y may be None when ``polar`` carries the render
        flow_x = _to_numpy(flow_x) if flow_x is not None else None
        flow_y = _to_numpy(flow_y) if flow_y is not None else None
        if save_flow and self._save:
            save_name = self.get_filename_from_prefix(file_prefix).replace("png", "npy")
            flow_arr = np.stack([flow_x, flow_y], axis=0)
            # the ~7 MB f32 disk write rides the writer thread too
            self._enqueue(lambda a=flow_arr, f=save_name: np.save(f, a))
            self.rollback_save_count(file_prefix)
        if polar is not None:
            if not self._show and self._save:
                # deferred render: value scaling + HSV→RGB on the writer
                image = self._save_image_deferred(
                    lambda p=polar: self.color_optical_flow_from_polar(*p)[0],
                    file_prefix)
                if visualize_color_wheel:
                    self._save_image_deferred(
                        lambda n=np.asarray(polar[1]).shape[0]:
                        self._color_wheel(n),
                        fixed_file_name="color_wheel")
                return image
            rgb, _ = self.color_optical_flow_from_polar(*polar)
            wheel = self._color_wheel(rgb.shape[0])
        else:
            rgb, wheel, _ = self.color_optical_flow(flow_x, flow_y, ord=ord)
        image = Image.fromarray(rgb)
        image = self._show_or_save_image(image, file_prefix)
        if visualize_color_wheel:
            self._show_or_save_image(wheel, fixed_file_name="color_wheel")
        return image

    def visualize_optical_flow_pred_and_gt(self, flow_pred, flow_gt,
                                           visualize_color_wheel=True,
                                           pred_file_prefix=None,
                                           gt_file_prefix=None, ord=0.5,
                                           polar_pred=None, polar_gt=None):
        """Common-scale pred/GT pair.

        With ``polar_pred``/``polar_gt`` (device-rendered polar planes) the
        shared normalization is the max of the two magnitude planes and no
        host-side colorization math runs.
        """
        if polar_pred is not None and polar_gt is not None:
            mp = float(np.asarray(polar_pred[1], np.float32).max())
            mg = float(np.asarray(polar_gt[1], np.float32).max())
            mm = max(mp, mg)
            mm = mm if mm > 0 else 1.0
            if not self._show and self._save:
                self._save_image_deferred(
                    lambda p=polar_pred, m=mm:
                    self.color_optical_flow_from_polar(*p, m)[0],
                    pred_file_prefix)
                self._save_image_deferred(
                    lambda p=polar_gt, m=mm:
                    self.color_optical_flow_from_polar(*p, m)[0],
                    gt_file_prefix)
                if visualize_color_wheel:
                    self._save_image_deferred(
                        lambda n=np.asarray(polar_pred[1]).shape[0]:
                        self._color_wheel(n),
                        fixed_file_name="color_wheel")
                return
            rgb_p, _ = self.color_optical_flow_from_polar(*polar_pred, mm)
            rgb_g, _ = self.color_optical_flow_from_polar(*polar_gt, mm)
            wheel = self._color_wheel(rgb_p.shape[0])
        else:
            flow_pred = _to_numpy(flow_pred)
            flow_gt = _to_numpy(flow_gt)
            _, _, mp = self.color_optical_flow(flow_pred[0], flow_pred[1], ord=ord)
            _, _, mg = self.color_optical_flow(flow_gt[0], flow_gt[1], ord=ord)
            mm = max(mp, mg)
            rgb_p, _, _ = self.color_optical_flow(flow_pred[0], flow_pred[1], mm, ord)
            rgb_g, wheel, _ = self.color_optical_flow(flow_gt[0], flow_gt[1], mm, ord)
        self._show_or_save_image(rgb_p, pred_file_prefix)
        self._show_or_save_image(rgb_g, gt_file_prefix)
        if visualize_color_wheel:
            self._show_or_save_image(wheel, fixed_file_name="color_wheel")

    def visualize_overlay_optical_flow_on_event(self, flow, events,
                                                file_prefix=None, ord=0.5):
        """Alpha overlay of the flow color on the event image."""
        from PIL import Image

        show, save = self._show, self._save
        self._show = self._save = False
        flow = _to_numpy(flow)
        flow_image = self.visualize_optical_flow(flow[0], flow[1], False, ord=ord)
        flow_image.putalpha(int(255 * 0.8))
        ev = _to_numpy(events)
        if ev.ndim == 2 and ev.shape[1] == 4:
            event_image = self.visualize_event(ev, grayscale=False).convert("RGB")
        else:
            event_image = self.visualize_image(ev).convert("RGB")
        event_image.putalpha(255 - int(255 * 0.8))
        flow_image.paste(event_image, None, event_image)
        self._show, self._save = show, save
        return self._show_or_save_image(flow_image, file_prefix)

    def visualize_optical_flow_on_event_mask(self, flow, events, file_prefix=None,
                                             ord=0.5, max_color_on_mask=True,
                                             mask_color="white",
                                             mask_morph=False, mask=None,
                                             polar=None):
        """Flow colorized only on event pixels.

        ``mask`` optionally supplies a precomputed ``[1, H, W]`` event mask
        (the render bundle's); otherwise it is voted from ``events`` on the
        Visualizer's device.  ``polar`` optionally
        supplies the device-rendered ``(ang_u8, magp)`` planes of the
        *unmasked* flow: masking multiplies the magnitude plane (``mag**ord
        · m ≡ (mag·m)**ord`` for a 0/1 mask) and the hue of masked-out
        pixels is irrelevant (they are composited to the solid fill), so
        the masked colorization needs no host float math.
        """
        import cv2
        from PIL import Image

        if mask is None:
            from .ops.iwe import create_eventmask
            from .types import bucket_capacity, events_from_ndarray

            arr = _to_numpy(events)
            ev = events_from_ndarray(arr, capacity=bucket_capacity(len(arr)),
                                     device=self.device)
            mask = create_eventmask(ev, self._image_size)
        mask = _to_numpy(mask)
        if polar is not None and max_color_on_mask and (self._save
                                                        and not self._show):
            # fully deferred: morph + mask-multiply + colorize + composite
            # all run on the writer thread (self-contained closure — no
            # reads of toggling _show/_save state)
            ang, magp = polar
            fill = (255, 255, 255) if mask_color == "white" else (0, 0, 0)

            def render(ang=np.asarray(ang), magp=np.asarray(magp),
                       mask=mask, morph=mask_morph, fill=fill):
                if morph:
                    el = cv2.getStructuringElement(cv2.MORPH_CROSS, (3, 3),
                                                   (1, 1))
                    mask = cv2.morphologyEx(mask.astype(np.uint8)[0],
                                            cv2.MORPH_CLOSE,
                                            el).astype(bool)[None]
                rgb, _ = self.color_optical_flow_from_polar(
                    ang, np.asarray(magp, np.float32) * mask[0])
                pil_mask = Image.fromarray((~mask)[0]).convert("1")
                solid = Image.new("RGB", (rgb.shape[1], rgb.shape[0]), fill)
                return Image.composite(solid, Image.fromarray(rgb), pil_mask)

            return self._save_image_deferred(render, file_prefix)
        show, save = self._show, self._save
        self._show = self._save = False
        flow = _to_numpy(flow) if flow is not None else None
        if mask_morph:
            element = cv2.getStructuringElement(cv2.MORPH_CROSS, (3, 3), (1, 1))
            mask = cv2.morphologyEx(mask.astype(np.uint8)[0], cv2.MORPH_CLOSE,
                                    element).astype(bool)[None]
        if polar is not None:
            ang, magp = polar
            if max_color_on_mask:
                magp = np.asarray(magp, np.float32) * mask[0]
            image = self.visualize_optical_flow(None, None, False,
                                                polar=(ang, magp))
        elif max_color_on_mask:
            mf = flow * mask
            image = self.visualize_optical_flow(mf[0], mf[1], False, ord=ord)
        else:
            image = self.visualize_optical_flow(flow[0], flow[1], False, ord=ord)
        pil_mask = Image.fromarray((~mask)[0]).convert("1")
        fill = (255, 255, 255) if mask_color == "white" else (0, 0, 0)
        solid = Image.new("RGB", image.size, fill)
        out = Image.composite(solid, image, pil_mask)
        self._show, self._save = show, save
        return self._show_or_save_image(out, file_prefix)

    # -- poisson view ------------------------------------------------------------
    def visualize_poisson_integration(self, flow, file_prefix=None,
                                      image=None):
        """The Poisson view of ``flow``, computed on the Visualizer's
        device.  ``image`` optionally supplies the precomputed uint8 view
        (``solver.api.SolverBase.render_bundle``)."""
        if image is None:
            flow = _to_numpy(flow)
            image = _poisson_view(flow[1], flow[0], self.device)
        return self.visualize_image(image, file_prefix=file_prefix)

    # -- events -------------------------------------------------------------------
    def visualize_event(self, events, grayscale=True, background_color=127,
                        ignore_polarity=False, file_prefix=None):
        """Signed event accumulation image."""
        ev = _to_numpy(events)
        if len(ev) == 0:  # empty window → plain background frame
            blank = np.full(self._image_size, background_color if grayscale
                            else 255, np.uint8)
            return self._show_or_save_image(blank, file_prefix)

        def render(ev=ev):
            x = np.clip(ev[:, 0], 0, self._image_size[0] - 1).astype(np.int32)
            y = np.clip(ev[:, 1], 0, self._image_size[1] - 1).astype(np.int32)
            if grayscale:
                if ignore_polarity:
                    pol = np.ones(len(ev))
                else:
                    pol = ev[:, 3] * 2 - 1 if ev[:, 3].min() == 0 else ev[:, 3]
                # signed histogram via bincount over raveled indices —
                # faster than np.add.at, bit-identical output
                h, w = self._image_size
                image = np.bincount(x.astype(np.int64) * w + y,
                                    weights=pol, minlength=h * w).reshape(h, w)
                image = np.clip(image * 20 + background_color, 0,
                                255).astype(np.uint8)
            else:
                image = np.full(self._image_size + (3,), 255, np.uint8)
                colors = np.where(ev[:, 3:4] > 0, np.array([[255, 0, 0]]),
                                  np.array([[0, 0, 255]])).astype(np.uint8)
                image[x, y, :] = colors
            return image

        if self._save and not self._show:
            # the histogram render rides the writer thread
            return self._save_image_deferred(render, file_prefix)
        return self._show_or_save_image(render(), file_prefix)

    # -- arrays ---------------------------------------------------------------------
    def save_array(self, array, file_prefix=None, new_prefix=False):
        """Save ``array`` as ``{prefix}{count}.npy``."""
        save_name = self.get_filename_from_prefix(file_prefix).replace("png", "npy")
        np.save(save_name, _to_numpy(array))
        if not new_prefix:
            self.rollback_save_count(file_prefix)

    # -- video assembly ----------------------------------------------------------
    def visualize_sequential_images_as_video(self, prefix=None, fps: float = 20.0):
        """All pngs of a prefix → ``{prefix}.mp4``.

        When the prefix's incremental stream (see :meth:`enable_video_stream`)
        covered every frame on disk, this is just a writer release — no PNG
        re-read.  Identical mp4 bytes either way: PNG is lossless, so the
        streamed arrays equal ``cv2.imread`` of the written files and the
        ``mp4v`` encoder sees the same frame sequence.
        """
        self.flush()  # the frames may still be in the writer queue
        prefix = prefix or self.default_prefix
        files = glob.glob(os.path.join(self.save_dir, f"{prefix}*.png"))

        def index_of(f):
            m = re.match(rf"{re.escape(prefix)}(\d+)\.png$", os.path.basename(f))
            return int(m.group(1)) if m else None

        files = sorted([f for f in files if index_of(f) is not None], key=index_of)
        out_path = os.path.join(self.save_dir, f"{prefix}.mp4")
        st = self._video_streams.pop(prefix, None)
        if st is not None:
            # complete ⇔ contiguous 0..n-1 was streamed and that is exactly
            # what is on disk (a resumed run has earlier PNGs this process
            # never saw; a dead stream dropped out mid-way)
            complete = (not st["dead"] and st["writer"] is not None
                        and not st["pending"] and fps == self.video_fps
                        and st["next"] == len(files)
                        and files and index_of(files[-1]) == st["next"] - 1)
            if st["writer"] is not None:
                st["writer"].release()
            if complete:
                return out_path
            logger.info("video stream for %r incomplete — rebuilding from "
                        "PNGs", prefix)
        return write_video(files, out_path, fps)

    def concat_videos(self, video_prefixes: List[str], out_name: str):
        """Side-by-side comparison video."""
        paths = [os.path.join(self.save_dir, f"{p}.mp4") for p in video_prefixes]
        out = os.path.join(self.save_dir, f"{out_name}.mp4")
        return concat_videos_horizontally(paths, out, labels=video_prefixes)

    # -- optimization history -----------------------------------------------------
    def _can_plot(self) -> bool:
        """Whether matplotlib imports; the first miss logs one warning,
        and the history and vector-field plots then write nothing."""
        if self._matplotlib is None:
            try:
                import matplotlib  # noqa: F401
                self._matplotlib = True
            except ImportError:
                self._matplotlib = False
                logger.warning("matplotlib is not installed: the loss-history "
                               "and vector-field plots are not written")
        return self._matplotlib

    def visualize_scipy_history(self, cost_history: dict, cost_weight=None,
                                file_prefix: str = "optimization_steps"):
        """Loss-curve plot, one curve per key of ``cost_history``.

        The figure is built once per prefix and per-frame calls only
        ``set_data`` + autoscale + save (a fresh figure's legend and font
        layout dominate its cost) — same axes/legend/autoscale, so the
        rendered plot is identical.  The whole update runs on the writer
        thread (which exclusively owns the persistent figures — Agg is
        safe off the main thread), keeping it off the dispatch path.
        Writes nothing where matplotlib cannot be imported
        (:meth:`_can_plot`)."""
        series = {}
        for k, v in cost_history.items():
            v = np.asarray(v, dtype=np.float64).reshape(-1)
            if v.size == 0:
                continue
            if cost_weight is not None and k in cost_weight:
                v = v * cost_weight[k]
            series[k] = v
        if not self._save or not self._can_plot():
            return
        fname = self.get_filename_from_prefix(file_prefix)

        def _render(series=series, fname=fname, key=file_prefix):
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            state = self._hist_state.get(key)
            if state is not None and set(state["lines"]) != set(series):
                plt.close(state["fig"])
                state = None
            if state is None:
                fig, ax = plt.subplots()
                lines = {}
                for k, v in series.items():
                    (lines[k],) = ax.plot(v, label=k)
                ax.legend()
                ax.set_xlabel("iteration")
                ax.set_ylabel("cost")
                state = {"fig": fig, "ax": ax, "lines": lines}
                self._hist_state[key] = state
            else:
                for k, v in series.items():
                    state["lines"][k].set_data(np.arange(v.size), v)
                state["ax"].relim()
                state["ax"].autoscale_view()
            state["fig"].savefig(fname)

        self._enqueue(_render)

    def visualize_plt_figure(self, fig, file_prefix: Optional[str] = None):
        """Save a matplotlib figure under the prefix-counter naming scheme
        (nothing where matplotlib cannot be imported)."""
        if fig is None or not self._can_plot():
            return
        if self._save:
            fig.savefig(self.get_filename_from_prefix(file_prefix),
                        bbox_inches="tight")
        import matplotlib.pyplot as plt

        plt.close(fig)

    def visualize_vector_field(self, flow, step: int = 8, scale=None,
                               file_prefix: str = "vector_field"):
        """Quiver plot of a dense flow field.

        Equivalent of OpenPIV's ``display_vector_field``.  Writes nothing
        where matplotlib cannot be imported (:meth:`_can_plot`).
        """
        if not self._can_plot():
            return
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        flow = _to_numpy(flow)
        h, w = flow.shape[-2:]
        ys, xs = np.mgrid[step // 2:h:step, step // 2:w:step]
        u = flow[1, ys, xs]   # col displacement → plot x
        v = flow[0, ys, xs]   # row displacement → plot y (inverted axis)
        fig, ax = plt.subplots(figsize=(8, 8 * h / w))
        ax.quiver(xs, ys, u, -v, angles="xy", scale=scale, color="tab:blue")
        ax.set_xlim(0, w)
        ax.set_ylim(h, 0)
        ax.set_aspect("equal")
        if self._save:
            fig.savefig(self.get_filename_from_prefix(file_prefix),
                        bbox_inches="tight")
        plt.close(fig)

    def visualize_optuna_history(self, losses, file_prefix: str = "sampler_history"):
        """Sampler-trial loss scatter.  Same persistent
        writer-owned figure scheme as :meth:`visualize_scipy_history`
        (nothing where matplotlib cannot be imported)."""
        if not self._save or not self._can_plot():
            return
        losses = np.asarray(losses, dtype=np.float64).reshape(-1)
        fname = self.get_filename_from_prefix(file_prefix)

        def _render(losses=losses, fname=fname, key="__optuna__" + file_prefix):
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            state = self._hist_state.get(key)
            if state is None:
                fig, ax = plt.subplots()
                (line,) = ax.plot(losses, ".")
                ax.set_xlabel("trial")
                ax.set_ylabel("objective")
                state = {"fig": fig, "ax": ax, "lines": {"": line}}
                self._hist_state[key] = state
            else:
                state["lines"][""].set_data(np.arange(losses.size), losses)
                state["ax"].relim()
                state["ax"].autoscale_view()
            state["fig"].savefig(fname)

        self._enqueue(_render)
