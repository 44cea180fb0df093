"""Camera model library: pinhole, MEI (catadioptric), Kannala-Brandt
equidistant, Scaramuzza omnidirectional.

Port of vil_fusion_tpu/models/cameras.py (the camodocal models the
reference vendors: PinholeCamera.cc, CataCamera.cc, EquidistantCamera.cc,
ScaramuzzaCamera.cc, CameraFactory.cc) on torch tensors.

Each model is a NamedTuple of parameters with two pure batched functions:
  * space_to_plane(cam, pts3d (..., 3)) -> (..., 2) pixels
  * lift_projective(cam, px (..., 2))   -> (..., 3) unit-norm rays
Backward (undistortion) maps use fixed-iteration solves (8 steps) instead of
the reference's recursive/iterative loops. Parameters are Python floats, so
a camera is device-free and hashable.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class PinholeCamera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0


class MeiCamera(NamedTuple):
    """Unified (catadioptric) model: mirror xi + radtan + projective gamma."""

    xi: float
    k1: float
    k2: float
    p1: float
    p2: float
    gamma1: float
    gamma2: float
    u0: float
    v0: float


class EquidistantCamera(NamedTuple):
    """Kannala-Brandt: theta + k2 theta^3 + ... + k5 theta^9."""

    k2: float
    k3: float
    k4: float
    k5: float
    mu: float
    mv: float
    u0: float
    v0: float


class ScaramuzzaCamera(NamedTuple):
    """Omnidirectional polynomial model (poly for lift, inv-poly for project)."""

    poly: tuple  # (p0..p4) rho -> z
    inv_poly: tuple  # inverse polynomial theta -> rho (len arbitrary)
    c: float = 1.0
    d: float = 0.0
    e: float = 0.0
    xc: float = 0.0
    yc: float = 0.0


def _radtan(k1, k2, p1, p2, mx, my):
    r2 = mx * mx + my * my
    rad = k1 * r2 + k2 * r2 * r2
    dx = mx * rad + 2 * p1 * mx * my + p2 * (r2 + 2 * mx * mx)
    dy = my * rad + p1 * (r2 + 2 * my * my) + 2 * p2 * mx * my
    return dx, dy


# ---------------------------------------------------------------------------
# Pinhole (PinholeCamera.cc spaceToPlane/liftProjective)
# ---------------------------------------------------------------------------

def pinhole_project(cam: PinholeCamera, pts):
    z = torch.clamp(pts[..., 2], min=1e-6)
    mx = pts[..., 0] / z
    my = pts[..., 1] / z
    dx, dy = _radtan(cam.k1, cam.k2, cam.p1, cam.p2, mx, my)
    return torch.stack([cam.fx * (mx + dx) + cam.cx, cam.fy * (my + dy) + cam.cy], dim=-1)


def pinhole_lift(cam: PinholeCamera, px, iters: int = 8):
    mx_d = (px[..., 0] - cam.cx) / cam.fx
    my_d = (px[..., 1] - cam.cy) / cam.fy
    mx = mx_d
    my = my_d
    for _ in range(iters):  # fixed-point undistortion (recursive in reference)
        dx, dy = _radtan(cam.k1, cam.k2, cam.p1, cam.p2, mx, my)
        mx = mx_d - dx
        my = my_d - dy
    ray = torch.stack([mx, my, torch.ones_like(mx)], dim=-1)
    return ray / torch.linalg.norm(ray, dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# MEI / unified model (CataCamera.cc)
# ---------------------------------------------------------------------------

def mei_project(cam: MeiCamera, pts):
    norm = torch.linalg.norm(pts, dim=-1)
    z = pts[..., 2] + cam.xi * norm
    z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    mx = pts[..., 0] / z
    my = pts[..., 1] / z
    dx, dy = _radtan(cam.k1, cam.k2, cam.p1, cam.p2, mx, my)
    return torch.stack([cam.gamma1 * (mx + dx) + cam.u0,
                      cam.gamma2 * (my + dy) + cam.v0], dim=-1)


def mei_lift(cam: MeiCamera, px, iters: int = 8):
    mx_d = (px[..., 0] - cam.u0) / cam.gamma1
    my_d = (px[..., 1] - cam.v0) / cam.gamma2
    mx = mx_d
    my = my_d
    for _ in range(iters):
        dx, dy = _radtan(cam.k1, cam.k2, cam.p1, cam.p2, mx, my)
        mx = mx_d - dx
        my = my_d - dy
    # undo mirror transform (CataCamera.cc liftProjective)
    r2 = mx * mx + my * my
    xi = cam.xi
    disc = 1.0 + (1.0 - xi * xi) * r2
    zs = 1.0 - xi * (r2 + 1.0) / (xi + torch.sqrt(torch.clamp(disc, min=0.0)))
    ray = torch.stack([mx, my, zs], dim=-1)
    return ray / torch.linalg.norm(ray, dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# Kannala-Brandt equidistant fisheye (EquidistantCamera.cc)
# ---------------------------------------------------------------------------

def _kb_theta_poly(cam: EquidistantCamera, theta):
    t2 = theta * theta
    return theta * (1.0 + t2 * (cam.k2 + t2 * (cam.k3 + t2 * (cam.k4 + t2 * cam.k5))))


def equidistant_project(cam: EquidistantCamera, pts):
    r_xy = torch.linalg.norm(pts[..., :2], dim=-1)
    theta = torch.atan2(r_xy, pts[..., 2])
    rho = _kb_theta_poly(cam, theta)
    scale = rho / torch.clamp(r_xy, min=1e-9)
    return torch.stack([cam.mu * scale * pts[..., 0] + cam.u0,
                      cam.mv * scale * pts[..., 1] + cam.v0], dim=-1)


def equidistant_lift(cam: EquidistantCamera, px, iters: int = 10):
    mx = (px[..., 0] - cam.u0) / cam.mu
    my = (px[..., 1] - cam.v0) / cam.mv
    rho = torch.sqrt(mx * mx + my * my)
    # Newton solve theta from rho = poly(theta) (reference uses a
    # polynomial-root (companion-matrix) solver; Newton from theta=rho is
    # equivalent for physical FOVs)
    theta = rho
    for _ in range(iters):
        t2 = theta * theta
        f = _kb_theta_poly(cam, theta) - rho
        df = 1.0 + t2 * (3 * cam.k2 + t2 * (5 * cam.k3 + t2 * (7 * cam.k4 + t2 * 9 * cam.k5)))
        theta = theta - f / torch.where(torch.abs(df) < 1e-9, torch.full_like(df, 1e-9), df)
    phi = torch.atan2(my, mx)
    st = torch.sin(theta)
    ray = torch.stack([st * torch.cos(phi), st * torch.sin(phi), torch.cos(theta)], dim=-1)
    return ray


# ---------------------------------------------------------------------------
# Scaramuzza omnidirectional (ScaramuzzaCamera.cc)
# ---------------------------------------------------------------------------

def scaramuzza_project(cam: ScaramuzzaCamera, pts):
    norm_xy = torch.linalg.norm(pts[..., :2], dim=-1)
    theta = torch.atan2(-pts[..., 2], norm_xy)  # angle from xy-plane, mirror down
    rho = torch.zeros_like(theta)
    for c in reversed(cam.inv_poly):
        rho = rho * theta + c
    scale = rho / torch.clamp(norm_xy, min=1e-9)
    xn = pts[..., 0] * scale
    yn = pts[..., 1] * scale
    u = xn * cam.c + yn * cam.d + cam.xc
    v = xn * cam.e + yn + cam.yc
    return torch.stack([u, v], dim=-1)


def scaramuzza_lift(cam: ScaramuzzaCamera, px):
    # invert affine
    u = px[..., 0] - cam.xc
    v = px[..., 1] - cam.yc
    det = cam.c - cam.d * cam.e
    xn = (u - cam.d * v) / det
    yn = (-cam.e * u + cam.c * v) / det
    rho = torch.sqrt(xn * xn + yn * yn)
    z = torch.zeros_like(rho)
    for c in reversed(cam.poly):
        z = z * rho + c
    ray = torch.stack([xn, yn, -z], dim=-1)
    return ray / torch.linalg.norm(ray, dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# Dispatch (CameraFactory.cc analog)
# ---------------------------------------------------------------------------

PROJECT = {
    PinholeCamera: pinhole_project,
    MeiCamera: mei_project,
    EquidistantCamera: equidistant_project,
    ScaramuzzaCamera: scaramuzza_project,
}
LIFT = {
    PinholeCamera: pinhole_lift,
    MeiCamera: mei_lift,
    EquidistantCamera: equidistant_lift,
    ScaramuzzaCamera: scaramuzza_lift,
}


def project(cam, pts):
    return PROJECT[type(cam)](cam, pts)


def lift(cam, px):
    return LIFT[type(cam)](cam, px)


def from_config(d: dict):
    """Build a camera from a config dict (config.py YAML loader)."""
    t = d.get("model_type", "PINHOLE").upper()
    if t == "PINHOLE":
        dp = d.get("distortion_parameters", {})
        pp = d.get("projection_parameters", {})
        return PinholeCamera(
            fx=pp["fx"], fy=pp["fy"], cx=pp["cx"], cy=pp["cy"],
            k1=dp.get("k1", 0.0), k2=dp.get("k2", 0.0),
            p1=dp.get("p1", 0.0), p2=dp.get("p2", 0.0))
    if t == "MEI":
        mp = d["mirror_parameters"]
        dp = d["distortion_parameters"]
        pp = d["projection_parameters"]
        return MeiCamera(xi=mp["xi"], k1=dp["k1"], k2=dp["k2"], p1=dp["p1"],
                         p2=dp["p2"], gamma1=pp["gamma1"], gamma2=pp["gamma2"],
                         u0=pp["u0"], v0=pp["v0"])
    if t in ("KANNALA_BRANDT", "EQUIDISTANT"):
        pp = d["projection_parameters"]
        return EquidistantCamera(k2=pp["k2"], k3=pp["k3"], k4=pp["k4"],
                                 k5=pp["k5"], mu=pp["mu"], mv=pp["mv"],
                                 u0=pp["u0"], v0=pp["v0"])
    if t == "SCARAMUZZA":
        return ScaramuzzaCamera(poly=tuple(d["poly_parameters"].values()),
                                inv_poly=tuple(d["inv_poly_parameters"].values()),
                                c=d["affine_parameters"]["ac"],
                                d=d["affine_parameters"]["ad"],
                                e=d["affine_parameters"]["ae"],
                                xc=d["affine_parameters"]["cx"],
                                yc=d["affine_parameters"]["cy"])
    raise ValueError(f"unknown camera model {t}")
