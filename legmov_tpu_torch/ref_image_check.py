"""Cross-check the port's kernels against the reference's committed renders.

The reference repo commits expected result images
(reachability_result_{side,top}.jpg, distance_result_{side,top}.jpg,
produced by after.py:150-283 from its CUDA kernels on the M2 leg).  This
tool regenerates the same four slices and writes a JSON of silhouette
landmarks (extents, notch, area), and, where matplotlib imports, the four
images: the one semantic anchor that does not depend on this repo's own
oracle.  ``bdata/refcheck/landmarks.json`` (tibia 135) and
``bdata/refcheck_hist/landmarks.json`` (``--tibia 160``) are the records
the landmarks are held to.

Slices (after.py / setting.py): side = the y = 0 plane over x in [-100,
601), z in [-350, 51) (11,421 points); top = the z = Z_CUT (-200) plane
over x, y in [-400, 401) (22,701 points); pitch PIX = 5 mm.  On the card
reachability is K1 and distance K2's point driver (ops/cuda_kernels.py,
the route of ``cli evaluate``); with ``--device cpu`` the plain
ops/reachability.py and ops/distance.py.

Run: ``python -m legmov_tpu_torch.ref_image_check [--device cpu]
[--tibia 160] [--out build/refcheck]``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from legmov_tpu_torch.config import resolve_device
from legmov_tpu_torch.models.leg import get_m2_leg
from legmov_tpu_torch.viz import (
    pyplot_or_none,
    render_distance,
    render_reachability,
)

PIX = 5.0
Z_CUT = -200.0


def grid(xs, ys, zs):
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    return np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1).astype(np.float32)


def slices() -> dict:
    """The two query grids, ``name -> [N, 3] float32``."""
    xs = np.arange(-100, 601, PIX, dtype=np.float32)
    zs = np.arange(-350, 51, PIX, dtype=np.float32)
    ys = np.arange(-400, 401, PIX, dtype=np.float32)
    return {"side": grid(xs, np.zeros(1, np.float32), zs),
            "top": grid(xs, ys, np.asarray([Z_CUT], np.float32))}


def landmarks(pts: np.ndarray, reach: np.ndarray) -> dict:
    """Silhouette landmarks comparable against the committed images."""
    r = pts[reach]
    if r.shape[0] == 0:
        return {"empty": True}
    return {
        "x_min": float(r[:, 0].min()),
        "x_max": float(r[:, 0].max()),
        "z_min": float(r[:, 2].min()),
        "z_max": float(r[:, 2].max()),
        "y_min": float(r[:, 1].min()),
        "y_max": float(r[:, 1].max()),
        "area_mm2": float(reach.sum()) * PIX * PIX,
    }


def notch(pts: np.ndarray, reach: np.ndarray):
    """The side silhouette's characteristic notch: the local maximum of the
    lower reachability boundary between x = 50 and x = 250 (visible at
    about (140, -170) in the reference render), or None."""
    nx, nz = [], []
    for xi in np.arange(50, 250, PIX):
        col = reach[(pts[:, 0] == np.float32(xi))]
        zcol = pts[pts[:, 0] == np.float32(xi), 2]
        if col.any():
            nx.append(xi)
            nz.append(zcol[col].min())
    if not nz:
        return None
    j = int(np.argmax(nz))
    return [float(nx[j]), float(nz[j])]


def evaluators(leg, device: torch.device):
    """``(reach(pts) -> [N] bool, dist(pts) -> [N, 3] float32)`` on numpy
    points: K1 and K2's point driver on the card (SoA, as ``cli evaluate``
    runs them), the plain tensor functions elsewhere."""
    if device.type == "cuda":
        from legmov_tpu_torch.ops.cuda_kernels import (
            make_distance_kernel,
            make_reachability_kernel,
        )

        kr, kd = make_reachability_kernel(leg), make_distance_kernel(leg)

        def soa(pts):
            return [torch.from_numpy(np.ascontiguousarray(pts[:, i])).to(device)
                    for i in range(3)]

        def reach(pts):
            return kr.soa(*soa(pts)).cpu().numpy()

        def dist(pts):
            _, dx, dy, dz = kd.soa(*soa(pts))
            return torch.stack([dx, dy, dz], -1).cpu().numpy()
        return reach, dist

    from legmov_tpu_torch.ops.distance import distance
    from legmov_tpu_torch.ops.reachability import reachability

    def reach(pts):
        return reachability(torch.from_numpy(pts).to(device), leg).cpu().numpy()

    def dist(pts):
        return distance(torch.from_numpy(pts).to(device), leg)[1].cpu().numpy()
    return reach, dist


def check(leg, device) -> tuple[dict, dict]:
    """Both slices for ``leg`` on ``device``: ``(report, arrays)``, the
    report as the JSON holds it and ``arrays[name] = (pts, reach, vec)``."""
    reach_fn, dist_fn = evaluators(leg, resolve_device(device))
    report = {"tibia_length": float(leg.tibia_length)}
    arrays = {}
    for name, pts in slices().items():
        reach, vec = reach_fn(pts), dist_fn(pts)
        arrays[name] = (pts, reach, vec)
        report[name] = landmarks(pts, reach)
    side_notch = notch(*arrays["side"][:2])
    if side_notch is not None:
        report["side"]["notch_xz"] = side_notch
    return report, arrays


def write_images(arrays: dict, out: str) -> bool:
    """The four PNGs (viz.py), or False where matplotlib does not import."""
    if pyplot_or_none() is None:
        return False
    for name, axis, cut in (("side", 1, 0.0), ("top", 2, Z_CUT)):
        pts, reach, vec = arrays[name]
        where = "y=0" if name == "side" else f"z={Z_CUT:g}"
        render_reachability(
            pts, reach, os.path.join(out, f"reachability_{name}.png"),
            axis=axis, cut=cut,
            title=f"legmov_tpu_torch M2 reachability, {where}")
        render_distance(
            pts, vec, os.path.join(out, f"distance_{name}.png"), axis=axis,
            cut=cut, saturate=200.0, pix_size=PIX,
            title=f"legmov_tpu_torch M2 distance, {where}")
    return True


def main(argv=None):
    ap = argparse.ArgumentParser(prog="legmov_tpu_torch.ref_image_check")
    ap.add_argument("--out", default="build/refcheck")
    ap.add_argument("--device", default=None,
                    help="cuda (default: K1 and K2) or cpu (plain tensors)")
    ap.add_argument("--tibia", type=float, default=None,
                    help="override tibia_length (femur2tip). The committed "
                    "reference images predate the current "
                    "static_variables.cpp:75 value of 135: their silhouette "
                    "landmarks (x_max 514.6, z_min -335, x_min ~-25, "
                    "measured from the JPG's gridline pixels) are "
                    "reproduced by femur2tip=160, not 135.")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    leg = get_m2_leg()
    if args.tibia is not None:
        leg = leg._replace(tibia_length=np.float32(args.tibia))
    report, arrays = check(leg, device)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "landmarks.json"), "w") as f:
        json.dump(report, f, indent=2)
    if not write_images(arrays, args.out):
        print("images not written: no matplotlib")
    print(json.dumps(report, indent=2))
    return report, arrays


if __name__ == "__main__":
    main()
