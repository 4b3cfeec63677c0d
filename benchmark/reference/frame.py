"""The reference's live frame and batch prediction, in plain PyTorch and NumPy.

Live frame (the reference viewer's ``depth_live_dl``): BGR uint8 captures ->
RGB in [0, 1] -> rectified at capture size (OpenCV's undistort-rectify map of
the plumb-bob model, bilinear, zero outside) -> resized to the model size
(bilinear, half-pixel centres, no antialiasing) -> the StereoUNet in eval
mode -> disparity, log-variance and the views as uint8 (truncated).
Prediction: uint8 (N, H, W, 6) -> [0, 1] -> the StereoUNet in eval mode.

``precision`` is ``unet.forward``'s; with ``"bf16"`` the frame's scaling,
rectification and resize run in bfloat16 too.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import unet


def rectify_map(mtx, dist, rot, proj, size_wh) -> tuple[np.ndarray, np.ndarray]:
    """cv2.initUndistortRectifyMap for the plumb-bob model with up to 8
    coefficients: (map_x, map_y) float32 of shape (H, W)."""
    w, h = size_wh
    k = np.zeros(8)
    d = np.asarray(dist, np.float64).reshape(-1)[:8]
    k[: d.size] = d
    k1, k2, p1, p2, k3, k4, k5, k6 = k
    proj = np.asarray(proj, np.float64)
    u, v = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    rays = np.stack([(u - proj[0, 2]) / proj[0, 0], (v - proj[1, 2]) / proj[1, 1],
                     np.ones_like(u)], axis=-1) @ np.linalg.inv(np.asarray(rot, np.float64)).T
    x, y = rays[..., 0] / rays[..., 2], rays[..., 1] / rays[..., 2]
    r2 = x * x + y * y
    radial = (1 + r2 * (k1 + r2 * (k2 + r2 * k3))) / (1 + r2 * (k4 + r2 * (k5 + r2 * k6)))
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    mtx = np.asarray(mtx, np.float64)
    return ((mtx[0, 0] * xd + mtx[0, 2]).astype(np.float32),
            (mtx[1, 1] * yd + mtx[1, 2]).astype(np.float32))


def maps(calib, device) -> tuple[torch.Tensor, ...]:
    """(left x, left y, right x, right y) maps of a calibration bundle."""
    size = tuple(int(v) for v in np.asarray(calib["image_size"]).reshape(-1)[:2])
    left = rectify_map(calib["mtx_l"], calib["dist_l"], calib["R1"], calib["P1"], size)
    right = rectify_map(calib["mtx_r"], calib["dist_r"], calib["R2"], calib["P2"], size)
    return tuple(torch.from_numpy(m).to(device) for m in (*left, *right))


def remap(img: torch.Tensor, mx: torch.Tensor, my: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of (H, W, C) ``img`` at (mx, my); taps outside are 0."""
    h, w, _ = img.shape
    x0, y0 = torch.floor(mx), torch.floor(my)
    fx, fy = (mx - x0)[..., None].to(img.dtype), (my - y0)[..., None].to(img.dtype)
    x0, y0 = x0.long(), y0.long()

    def tap(yy, xx):
        inside = ((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w))[..., None]
        return img[yy.clamp(0, h - 1), xx.clamp(0, w - 1)] * inside

    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bottom = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bottom * fy


def live_frame(p, calib_maps, left_bgr, right_bgr, model_hw, precision="f32"):
    """One frame: (disparity, logvar, left view, right view) as numpy."""
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    device = calib_maps[0].device
    views = []
    for k, frame in enumerate((left_bgr, right_bgr)):
        rgb = torch.from_numpy(np.ascontiguousarray(frame[..., ::-1])).to(device)
        img = rgb.to(dtype) / 255.0
        img = remap(img, calib_maps[2 * k], calib_maps[2 * k + 1])
        img = F.interpolate(img.permute(2, 0, 1)[None], size=model_hw, mode="bilinear",
                            align_corners=False, antialias=False)[0].permute(1, 2, 0)
        views.append(img)
    x = torch.cat(views, dim=-1)[None].float()
    disp, logvar = unet.forward(p, x, train=False, precision=precision)
    out = [(v.clamp(0.0, 1.0) * 255.0).to(torch.uint8) for v in views]
    return tuple(t.cpu().numpy() for t in (disp[0], logvar[0], *out))


def predict(p, batch_u8: torch.Tensor, precision="f32"):
    """(N, H, W, 6) uint8 -> (disparity, logvar) as numpy."""
    x = batch_u8.float() / 255.0
    if precision == "bf16":
        x = x.to(torch.bfloat16).float()
    disp, logvar = unet.forward(p, x, train=False, precision=precision)
    return disp.cpu().numpy(), logvar.cpu().numpy()
