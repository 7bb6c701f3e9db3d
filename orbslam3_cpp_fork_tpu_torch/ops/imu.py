"""On-manifold IMU preintegration (port of ops/imu.py; IMU::Preintegrated,
include/ImuTypes.h:150-250, src/ImuTypes.cc:202-261).

The state (dR, dV, dP, C15, JRg, JVg, JVa, JPg, JPa, dT) and its
linearization biases are a dataclass of tensors that may carry leading batch
dimensions: the map stacks the preintegrations of a keyframe window into one
record, and every function here broadcasts over them.

`IntegrateNewMeasurement`'s A/B covariance propagation, the bias Jacobians
and the bias-corrected delta getters (GetDeltaRotation/Velocity/Position)
are reproduced in the reference's order; gravity is GRAVITY_VALUE = 9.81
(include/ImuTypes.h:37).

`preintegrate` steps through the measurement rows it is given in a Python
loop. The reference pads every window to a fixed capacity with a validity
mask so that its compiled scan never changes shape; a masked step leaves
the state unchanged bit for bit, so the port takes only the real rows and
stops there. A `valid` mask is still accepted, with the same semantics.
Each step is a hundred-odd small kernels (ROADMAP X7 is the single-block
kernel that would replace them on the card).
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import get_device
from ..utils import lie

GRAVITY = 9.81


def gravity_vec(device=None, dtype=torch.float32) -> torch.Tensor:
    """World gravity (0, 0, -9.81), made on the device (a host list uploaded
    at every residual would stall the card's stream)."""
    g = torch.zeros(3, dtype=dtype, device=device)
    g[2:].fill_(-GRAVITY)
    return g


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(device)


@dataclasses.dataclass(frozen=True)
class ImuCalib:
    """Noise densities already scaled to per-sample sigmas (the reference
    multiplies by sqrt(freq) at Settings load, src/Settings.cc:387-414), and
    the body-from-camera extrinsic Tbc."""

    sigma_gyro: torch.Tensor  # rad/s/sqrt(Hz) * sqrt(freq)
    sigma_acc: torch.Tensor
    walk_gyro: torch.Tensor
    walk_acc: torch.Tensor
    Tbc_R: torch.Tensor  # (3,3) body-from-camera rotation
    Tbc_t: torch.Tensor  # (3,)

    @staticmethod
    def create(ng, na, wg, wa, freq, Tbc_R=None, Tbc_t=None, device="cuda") -> "ImuCalib":
        """On the card unless `device` says "cpu" (`get_device`)."""
        sf = float(freq) ** 0.5
        dev = get_device(device)
        return ImuCalib(
            sigma_gyro=_f32(ng * sf, dev),
            sigma_acc=_f32(na * sf, dev),
            walk_gyro=_f32(wg / sf, dev),
            walk_acc=_f32(wa / sf, dev),
            Tbc_R=torch.eye(3, device=dev) if Tbc_R is None else _f32(Tbc_R, dev),
            Tbc_t=torch.zeros(3, device=dev) if Tbc_t is None else _f32(Tbc_t, dev),
        )

    @property
    def device(self) -> torch.device:
        return self.Tbc_R.device


@dataclasses.dataclass(frozen=True)
class Preintegrated:
    """Preintegrated deltas between two frames or keyframes, with optional
    leading batch dimensions on every field."""

    dR: torch.Tensor  # (...,3,3)
    dV: torch.Tensor  # (...,3)
    dP: torch.Tensor  # (...,3)
    C: torch.Tensor  # (...,15,15) covariance [rot, vel, pos, gyro-walk, acc-walk]
    JRg: torch.Tensor  # (...,3,3) d(dR)/d(bg)
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    dT: torch.Tensor  # (...) total time
    bias_gyro: torch.Tensor  # (...,3) linearization bias
    bias_acc: torch.Tensor

    @staticmethod
    def identity(bias_gyro: torch.Tensor, bias_acc: torch.Tensor) -> "Preintegrated":
        """The empty interval at biases (bias_gyro, bias_acc), with their
        batch shape and device."""
        batch, dev = bias_gyro.shape[:-1], bias_gyro.device
        z33 = torch.zeros((*batch, 3, 3), device=dev)
        return Preintegrated(
            dR=torch.eye(3, device=dev).expand(*batch, 3, 3).clone(),
            dV=torch.zeros((*batch, 3), device=dev),
            dP=torch.zeros((*batch, 3), device=dev),
            C=torch.zeros((*batch, 15, 15), device=dev),
            JRg=z33, JVg=z33, JVa=z33, JPg=z33, JPa=z33,
            dT=torch.zeros(batch, device=dev),
            bias_gyro=bias_gyro.float(),
            bias_acc=bias_acc.float(),
        )

    def map(self, fn) -> "Preintegrated":
        """Apply `fn` to every field (the reference's jax.tree.map)."""
        return Preintegrated(**{f.name: fn(getattr(self, f.name)) for f in dataclasses.fields(self)})


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", A, x)


def _blocks(rows) -> torch.Tensor:
    """A matrix from rows of (...,r,c) blocks."""
    return torch.cat([torch.cat(r, dim=-1) for r in rows], dim=-2)


def _row_terms(acc, gyro, dts, calib: ImuCalib, bias_gyro, bias_acc):
    """What each measurement step needs that does not depend on the state,
    for every row at once (...,T,...): the bias-corrected measurements, the
    step and its square, hat(a), the rotation increment Exp(w dt) and its
    right Jacobian, and the walk noise of the step. The recursion then does
    only what depends on the state."""
    a = acc - bias_acc[..., None, :]
    w = gyro - bias_gyro[..., None, :]
    dt = torch.as_tensor(dts, dtype=a.dtype, device=a.device)
    dt2 = dt * dt
    dtv, dt2v = dt[..., None], dt2[..., None]
    dtm, dt2m = dtv[..., None], dt2v[..., None]
    dRi = lie.so3_exp(w * dtv)
    Jr = lie.so3_right_jacobian(w * dtv)
    eye3 = torch.eye(3, dtype=a.dtype, device=a.device)
    n_walk = torch.stack([calib.walk_gyro**2] * 3 + [calib.walk_acc**2] * 3)
    return dict(a=a, dt=dt, dtv=dtv, dt2v=dt2v, dtm=dtm, dt2m=dt2m, Wa=lie.hat(a), dRi=dRi,
                dRiT=dRi.transpose(-1, -2), Jr_dt=Jr * dtm, eye_dt=eye3 * dtm, walk_dt=torch.diag_embed(n_walk) * dtm)


def _noise_ga(calib: ImuCalib) -> torch.Tensor:
    sg2, sa2 = calib.sigma_gyro**2, calib.sigma_acc**2
    return torch.stack([sg2, sg2, sg2, sa2, sa2, sa2])


def _step(state: Preintegrated, t: dict, n_ga, valid=None) -> Preintegrated:
    """One measurement step (IntegrateNewMeasurement, src/ImuTypes.cc:202-261)
    from its row terms `t` (`_row_terms` of that row). With `valid` (bool,
    the batch shape) a masked step leaves the state as it was."""
    dR, dV, dP = state.dR, state.dV, state.dP
    dtv, dt2v, dtm, dt2m = t["dtv"], t["dt2v"], t["dtm"], t["dt2m"]
    eye3 = torch.eye(3, dtype=dR.dtype, device=dR.device).expand(dR.shape)
    z33 = torch.zeros_like(eye3)

    # Position/velocity first (with dR before its update, as the reference).
    Ra = _mv(dR, t["a"])
    new_dP = dP + dV * dtv + 0.5 * Ra * dt2v
    new_dV = dV + Ra * dtv

    # Rotation update.
    dRi = t["dRi"]
    new_dR = lie.so3_normalize(dR @ dRi)

    # A/B of the covariance on [rot, vel, pos] (9x9 and 9x6).
    dRWa = dR @ t["Wa"]
    A = _blocks([
        [t["dRiT"].expand(dR.shape), z33, z33],
        [-dRWa * dtm, eye3, z33],
        [-0.5 * dRWa * dt2m, t["eye_dt"].expand(dR.shape), eye3],
    ])
    B = _blocks([
        [t["Jr_dt"].expand(dR.shape), z33],
        [z33, dR * dtm],
        [z33, 0.5 * dR * dt2m],
    ])
    C = state.C
    C9 = A @ C[..., :9, :9] @ A.transpose(-1, -2) + (B * n_ga) @ B.transpose(-1, -2)
    Cw = C[..., 9:, 9:] + t["walk_dt"]
    new_C = _blocks([[C9, C[..., :9, 9:]], [C[..., 9:, :9], Cw]])

    # Bias Jacobians (the reference's update order).
    new_JPa = state.JPa + state.JVa * dtm - 0.5 * dR * dt2m
    new_JPg = state.JPg + state.JVg * dtm - 0.5 * dRWa @ state.JRg * dt2m
    new_JVa = state.JVa - dR * dtm
    new_JVg = state.JVg - dRWa @ state.JRg * dtm
    new_JRg = t["dRiT"] @ state.JRg - t["Jr_dt"]

    new = Preintegrated(
        dR=new_dR, dV=new_dV, dP=new_dP, C=new_C,
        JRg=new_JRg, JVg=new_JVg, JVa=new_JVa, JPg=new_JPg, JPa=new_JPa,
        dT=state.dT + t["dt"], bias_gyro=state.bias_gyro, bias_acc=state.bias_acc,
    )
    if valid is None:
        return new

    def keep(n, o):
        v = valid.reshape(valid.shape + (1,) * (n.dim() - valid.dim()))
        return torch.where(v, n, o)

    return Preintegrated(**{f.name: keep(getattr(new, f.name), getattr(state, f.name))
                            for f in dataclasses.fields(Preintegrated)})


def integrate(state: Preintegrated, acc, gyro, dt, calib: ImuCalib, valid=None) -> Preintegrated:
    """One measurement step: acc, gyro (...,3), dt (...)."""
    return preintegrate(acc[..., None, :], gyro[..., None, :], torch.as_tensor(dt)[..., None], calib,
                        state.bias_gyro, state.bias_acc, init=state,
                        valid=None if valid is None else torch.as_tensor(valid)[..., None])


def preintegrate(acc, gyro, dts, calib: ImuCalib, bias_gyro, bias_acc, init: Preintegrated | None = None,
                 valid=None) -> Preintegrated:
    """Integrate measurement rows acc/gyro (...,T,3) with steps dts (...,T)
    (Tracking::PreintegrateIMU's per-measurement loop,
    src/Tracking.cc:1615-1711). Pass `init` to continue a running
    preintegration (the incremental mpImuPreintegratedFromLastKF), and
    `valid` (...,T) to mask rows as the reference's padded window does. The
    state-free part of every step is computed for all rows at once."""
    s = Preintegrated.identity(bias_gyro, bias_acc) if init is None else init
    T = acc.shape[-2]
    if T == 0:
        return s
    terms = _row_terms(acc, gyro, dts, calib, s.bias_gyro, s.bias_acc)
    n_ga = _noise_ga(calib)
    for i in range(T):
        row = {k: (v[..., i] if k == "dt" else v[..., i, :] if k in ("a", "dtv", "dt2v") else v[..., i, :, :])
               for k, v in terms.items()}
        s = _step(s, row, n_ga, None if valid is None else valid[..., i])
    return s


def delta_rotation(p: Preintegrated, bias_gyro) -> torch.Tensor:
    """Bias-corrected dR (GetDeltaRotation, src/ImuTypes.cc:283)."""
    db = bias_gyro - p.bias_gyro
    return lie.so3_normalize(p.dR @ lie.so3_exp(_mv(p.JRg, db)))


def delta_velocity(p: Preintegrated, bias_gyro, bias_acc) -> torch.Tensor:
    dbg = bias_gyro - p.bias_gyro
    dba = bias_acc - p.bias_acc
    return p.dV + _mv(p.JVg, dbg) + _mv(p.JVa, dba)


def delta_position(p: Preintegrated, bias_gyro, bias_acc) -> torch.Tensor:
    dbg = bias_gyro - p.bias_gyro
    dba = bias_acc - p.bias_acc
    return p.dP + _mv(p.JPg, dbg) + _mv(p.JPa, dba)


def predict_state(R1, p1, v1, pre: Preintegrated, bias_gyro, bias_acc):
    """Dead-reckoned world-frame state after the interval
    (Tracking::PredictStateIMU, src/Tracking.cc:1712-1772)."""
    t = pre.dT[..., None]
    g = gravity_vec(R1.device, R1.dtype)
    R2 = lie.so3_normalize(R1 @ delta_rotation(pre, bias_gyro))
    v2 = v1 + g * t + _mv(R1, delta_velocity(pre, bias_gyro, bias_acc))
    p2 = p1 + v1 * t + 0.5 * g * t * t + _mv(R1, delta_position(pre, bias_gyro, bias_acc))
    return R2, p2, v2
