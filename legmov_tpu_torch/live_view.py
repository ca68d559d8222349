"""Workspace slice explorer: the realtime-viewer counterpart.

Analogue of the reference's legacy SFML/OpenGL viewer
(``cuda_openGLmess.cu:1272-1632`` ``AutoEstimator`` + ``OpenGL_viz.cpp``):
a screen-sized query grid is re-evaluated through the distance kernel
every time the slice moves, the result norm is mapped through viridis (the
reference bakes its own LUT, ``cuda_virdis.cu:118-150``; matplotlib's
colormap serves here), and a numerical-derivative shading mode mirrors
``derivate_output`` (``cuda_openGLmess.cu:1474-1490``).

Two modes:

* ``--interactive``: a matplotlib window with a slice slider, an axis
  toggle (the reference's ``switch_zy``) and a norm/derivative toggle.
  Each slider move re-runs the kernel.  Needs matplotlib and a display.
* default (headless): steps the slice through ``--frames`` positions like
  a user dragging, one warm frame and then the timed frames (one K2
  launch each on the card), one synchronisation at the end, and reports
  the frame rate beside the device it ran on and K2's launch count; saves
  the first, middle and last frames as PNGs where matplotlib imports.

Run: ``python -m legmov_tpu_torch.live_view [--device cpu] [--frames 60]
[--out build/live_view]``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from legmov_tpu_torch.config import resolve_device
from legmov_tpu_torch.models.leg import get_m2_leg, get_moonbot_leg
from legmov_tpu_torch.ops import cuda_kernels as ck
from legmov_tpu_torch.ops import trig32
from legmov_tpu_torch.profiling import device_label
from legmov_tpu_torch.viz import pyplot_or_none


def make_frame_fn(leg, width: int, height: int, scale: float, device):
    """Returns ``frame(cut, axis_is_z) -> [H, W] float32`` norm image on
    ``device``: one K2 ``.soa`` launch a frame on the card (its plain
    version ``ck.distance_kernel_plain`` on the CPU), then the norm.

    The pixel grid is built once on the device (input_as_grid,
    cuda_openGLmess.cu:1336-1368 builds it per frame on the GPU).  With
    ``axis_is_z`` the slice is y = cut and the image axes are (x, z), else
    the slice is z = cut.  ``frame.plain`` computes the same frame through
    the kernel's plain version wherever the tensors live, and
    ``frame.points(cut, axis_is_z)`` gives a frame's ``(x, y, z)`` inputs.
    """
    dev = resolve_device(device)
    xs = (torch.arange(width, dtype=torch.float32, device=dev)
          - width / 4.0) * scale
    vs = (torch.arange(height, dtype=torch.float32, device=dev)
          - height / 2.0) * scale
    X, V = torch.meshgrid(xs, vs, indexing="xy")
    X, V = X.reshape(-1).contiguous(), V.reshape(-1).contiguous()
    kd = ck.make_distance_kernel(leg)

    def points(cut, axis_is_z):
        C = torch.full_like(X, float(np.float32(cut)))
        return (X, C, V) if axis_is_z else (X, V, C)

    def image(dx, dy, dz):
        return trig32.sqrt(dx * dx + dy * dy + dz * dz).reshape(height, width)

    def frame(cut, axis_is_z: bool = True) -> torch.Tensor:
        _, dx, dy, dz = kd.soa(*points(cut, axis_is_z))
        return image(dx, dy, dz)

    def plain(cut, axis_is_z: bool = True) -> torch.Tensor:
        _, dx, dy, dz = ck.distance_kernel_plain(*points(cut, axis_is_z),
                                                 kd.consts)
        return image(dx, dy, dz)

    frame.plain = plain
    frame.points = points
    return frame


def derivative_shade(img: np.ndarray) -> np.ndarray:
    """|d norm / d pixel| magnitude (derivate_output equivalent)."""
    gy, gx = np.gradient(img)
    return np.hypot(gx, gy)


def interactive(frame) -> None:
    """The slider window; raises where matplotlib or a display is missing."""
    try:
        import matplotlib.pyplot as plt
        from matplotlib.widgets import Button, Slider
    except ImportError as e:
        raise RuntimeError("--interactive needs matplotlib, which does not "
                           "import here") from e
    if not (os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")):
        raise RuntimeError("--interactive needs a display (DISPLAY is not "
                           "set); the headless mode runs without one")
    fig, ax = plt.subplots(figsize=(10, 6))
    plt.subplots_adjust(bottom=0.22)
    state = {"axis_z": True, "deriv": False}

    def render(cut):
        img = frame(cut, state["axis_z"]).cpu().numpy()
        return derivative_shade(img) if state["deriv"] else img

    im = ax.imshow(render(0.0), cmap="viridis", origin="lower")
    slider = Slider(plt.axes([0.15, 0.08, 0.6, 0.04]), "cut (mm)", -500.0,
                    500.0, valinit=0.0)
    btn = Button(plt.axes([0.8, 0.08, 0.08, 0.05]), "y/z")
    dbtn = Button(plt.axes([0.89, 0.08, 0.08, 0.05]), "d/dx")

    def update(_):
        im.set_data(render(slider.val))
        fig.canvas.draw_idle()

    def toggle(key):
        def flip(_):
            state[key] = not state[key]
            update(None)
        return flip

    slider.on_changed(update)
    btn.on_clicked(toggle("axis_z"))
    dbtn.on_clicked(toggle("deriv"))
    plt.show()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="legmov_tpu_torch.live_view")
    ap.add_argument("--leg", choices=("moonbot", "m2"), default="m2")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--scale", type=float, default=0.5, help="mm per pixel")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--interactive", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default: K2) or cpu (its plain version)")
    ap.add_argument("--out", default="build/live_view")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    leg = get_m2_leg() if args.leg == "m2" else get_moonbot_leg()
    frame = make_frame_fn(leg, args.width, args.height, args.scale, dev)
    if args.interactive:
        interactive(frame)
        return None

    # headless: sweep the cut like a user dragging the slider
    cuts = np.linspace(-400, 400, args.frames).astype(np.float32)
    launches0 = ck.distance_kernel.launches
    frame(cuts[0], True)  # warm
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for c in cuts:
        frame(c, True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    fps = args.frames / dt
    launches = ck.distance_kernel.launches - launches0
    label = device_label(dev)
    print(f"{args.frames} frames {args.width}x{args.height} in {dt:.4f} s "
          f"-> {fps:.1f} fps on {label} (warm frame excluded, one "
          f"synchronisation at the end); K2 launches {launches}")
    plt = pyplot_or_none()
    if plt is None:
        print("images not written: no matplotlib")
    else:
        os.makedirs(args.out, exist_ok=True)
        for tag, c in (("first", cuts[0]), ("mid", cuts[len(cuts) // 2]),
                       ("last", cuts[-1])):
            img = frame(c, True).cpu().numpy()
            for mode, data in (("norm", img), ("deriv", derivative_shade(img))):
                plt.figure(figsize=(8, 4.5))
                plt.imshow(data, cmap="viridis", origin="lower")
                plt.title(f"{args.leg} distance {mode}, y={c:.0f} mm")
                plt.axis("off")
                plt.savefig(os.path.join(args.out, f"{tag}_{mode}.png"),
                            dpi=110, bbox_inches="tight")
                plt.close()
        print("wrote frames to", args.out)
    return {"frames": args.frames, "seconds": dt, "fps": fps,
            "launches": launches, "device": label}


if __name__ == "__main__":
    main()
