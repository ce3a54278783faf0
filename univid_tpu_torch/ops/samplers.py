"""Flow-matching samplers: UniPC and DPM-Solver++.

Counterpart of univid_tpu/ops/samplers.py. Every per-step solver
coefficient is precomputed on the host in float64 (numpy, copied as it is
from the JAX package: it depends only on the sigma schedule and the step
index), and the step on the device is a linear combination

    x_next = A * x + sum_k c_k * m_k

of the sample and the history of converted outputs m = x - sigma * v.
Coefficients enter the step rounded to fp32, as the JAX package feeds them
to its scan; the solver state stays fp32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Sigma schedule
# ---------------------------------------------------------------------------


def flow_sigmas(num_steps: int, shift: float = 5.0,
                num_train_timesteps: int = 1000,
                sigmas: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Shifted flow-matching sigma schedule.

    Matches FlowUniPCMultistepScheduler.set_timesteps
    (fm_solvers_unipc.py:162-229) with the trained schedule from __init__
    (:109-120): train sigmas descend from 1 - 1/N to 0; inference sigmas are
    linspace over [sigma_max, sigma_min] then shifted
    sigma' = shift*s / (1 + (shift-1)*s), with a final 0 appended.

    Returns (sigmas [steps+1] float64, timesteps [steps] float64 — integer
    valued, matching the reference's int64 cast at :213).
    """
    n = num_train_timesteps
    sigma_max = 1.0 - 1.0 / n
    sigma_min = 1.0 / n * 0.0  # reference sigma_min = sigmas[-1] = 1 - 1 = 0
    # reference: alphas = linspace(1, 1/n, n)[::-1]; sigmas = 1 - alphas
    # so sigma_min = 1 - 1 = 0 and sigma_max = 1 - 1/n.
    if sigmas is None:
        sigmas = np.linspace(sigma_max, sigma_min, num_steps + 1,
                             dtype=np.float64)[:-1]
    else:
        sigmas = np.asarray(sigmas, dtype=np.float64)
    sigmas = shift * sigmas / (1.0 + (shift - 1.0) * sigmas)
    timesteps = np.floor(sigmas * n)  # int64 cast in reference
    sigmas = np.concatenate([sigmas, [0.0]])
    return sigmas, timesteps


def get_sampling_sigmas(sampling_steps: int, shift: float) -> np.ndarray:
    """DPM++ helper (reference fm_solvers.py get_sampling_sigmas): sigma grid
    1 -> 1/steps, then shifted."""
    sigma = np.linspace(1.0, 0.0, sampling_steps + 1, dtype=np.float64)[:sampling_steps]
    return (shift * sigma / (1.0 + (shift - 1.0) * sigma))


# ---------------------------------------------------------------------------
# UniPC (order-2 default predictor-corrector) — precomputed coefficients
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SolverCoeffs:
    """Per-step device coefficients, each array stacked over steps.

    sigma:    [S]            sigma_i for output conversion
    has_corr: [S]            1.0 where the corrector runs
    corr_a:   [S]            coefficient on last_sample
    corr_mt:  [S]            coefficient on the fresh converted output m_i
    corr_m:   [S, K]         coefficients on history (m_{i-1}, m_{i-2}, ...)
    pred_a:   [S]            coefficient on the (corrected) sample
    pred_m:   [S, K]         coefficients on history incl. m_i at index 0
    timesteps:[S]            model-conditioning timesteps
    """

    sigma: np.ndarray
    has_corr: np.ndarray
    corr_a: np.ndarray
    corr_mt: np.ndarray
    corr_m: np.ndarray
    pred_a: np.ndarray
    pred_m: np.ndarray
    timesteps: np.ndarray

    @property
    def num_steps(self) -> int:
        return self.sigma.shape[0]

    @property
    def order(self) -> int:
        return self.corr_m.shape[1]

    def step(self, i: int):
        """Step i's coefficients as fp32 Python scalars / tuples (what the
        device-side step functions take)."""
        f32 = lambda x: float(np.float32(x))  # noqa: E731
        return {
            "sigma": f32(self.sigma[i]),
            "has_corr": f32(self.has_corr[i]),
            "corr_a": f32(self.corr_a[i]),
            "corr_mt": f32(self.corr_mt[i]),
            "corr_m": tuple(f32(c) for c in self.corr_m[i]),
            "pred_a": f32(self.pred_a[i]),
            "pred_m": tuple(f32(c) for c in self.pred_m[i]),
            "timestep": f32(self.timesteps[i]),
        }


def _lam(sigma: float) -> float:
    alpha = 1.0 - sigma
    if sigma <= 0.0:
        return math.inf
    if alpha <= 0.0:
        return -math.inf
    return math.log(alpha) - math.log(sigma)


def _bh_terms(h: float, order: int, solver_type: str):
    """R matrix/b vector ingredients shared by UniP and UniC
    (fm_solvers_unipc.py:435-455)."""
    hh = -h  # predict_x0
    h_phi_1 = math.expm1(hh)
    if solver_type == "bh1":
        b_h = hh
    elif solver_type == "bh2":
        b_h = math.expm1(hh)
    else:
        raise NotImplementedError(solver_type)
    h_phi_k = h_phi_1 / hh - 1.0
    b = []
    factorial_i = 1.0
    for i in range(1, order + 1):
        b.append(h_phi_k * factorial_i / b_h)
        factorial_i *= i + 1
        h_phi_k = h_phi_k / hh - 1.0 / factorial_i
    return h_phi_1, b_h, np.asarray(b, dtype=np.float64)


def precompute_unipc(sigmas: np.ndarray, solver_order: int = 2,
                     solver_type: str = "bh2", lower_order_final: bool = True,
                     disable_corrector: Sequence[int] = (),
                     timesteps: Optional[np.ndarray] = None) -> SolverCoeffs:
    """Precompute UniPC predictor+corrector coefficients for every step.

    Algorithm follows fm_solvers_unipc.py:352-741 exactly (orders, warmup,
    corrector gating), re-expressed as per-step linear-combination weights.
    """
    sigmas = np.asarray(sigmas, dtype=np.float64)
    num_steps = sigmas.shape[0] - 1
    K = solver_order
    lam = np.array([_lam(s) for s in sigmas])
    alpha = 1.0 - sigmas

    # per-step predictor order (fm_solvers_unipc.py:714-722)
    orders = []
    lower = 0
    for i in range(num_steps):
        o = min(solver_order, num_steps - i) if lower_order_final \
            else solver_order
        o = min(o, lower + 1)
        orders.append(o)
        lower = min(lower + 1, solver_order)

    sigma_c = np.zeros(num_steps)
    has_corr = np.zeros(num_steps)
    corr_a = np.zeros(num_steps)
    corr_mt = np.zeros(num_steps)
    corr_m = np.zeros((num_steps, K))
    pred_a = np.zeros(num_steps)
    pred_m = np.zeros((num_steps, K))

    for i in range(num_steps):
        sigma_c[i] = sigmas[i]

        # ---- corrector (UniC) at step i, order = predictor order at i-1 ----
        if i > 0 and (i - 1) not in disable_corrector:
            p = orders[i - 1]
            has_corr[i] = 1.0
            s_t, s_s0 = sigmas[i], sigmas[i - 1]
            a_t = alpha[i]
            h = lam[i] - lam[i - 1]
            rks = [(lam[i - 1 - k] - lam[i - 1]) / h for k in range(1, p)]
            rks.append(1.0)
            rks = np.asarray(rks)
            h_phi_1, b_h, b = _bh_terms(h, p, solver_type)
            if p == 1:
                rhos_c = np.array([0.5])
            else:
                R = np.stack([rks ** (j) for j in range(p)])
                rhos_c = np.linalg.solve(R, b)
            corr_a[i] = s_t / s_s0
            # m0 = m_{i-1} = hist[0]; D1s[k-1] = (m_{i-1-k} - m0)/r_k
            corr_m[i, 0] = -a_t * h_phi_1 + a_t * b_h * (
                sum(rhos_c[k - 1] / rks[k - 1] for k in range(1, p))
                + rhos_c[-1])
            for k in range(1, p):
                corr_m[i, k] = -a_t * b_h * rhos_c[k - 1] / rks[k - 1]
            corr_mt[i] = -a_t * b_h * rhos_c[-1]

        # ---- predictor (UniP) at step i ----
        p = orders[i]
        s_t, s_s0 = sigmas[i + 1], sigmas[i]
        a_t = alpha[i + 1]
        h = lam[i + 1] - lam[i]
        h_phi_1, b_h, b = _bh_terms(h, p, solver_type)
        if p == 1:
            rhos_p = np.zeros(0)
            rks = np.zeros(0)
        else:
            rks = [(lam[i - k] - lam[i]) / h for k in range(1, p)]
            rks.append(1.0)
            rks = np.asarray(rks)
            if p == 2:
                rhos_p = np.array([0.5])
            else:
                R = np.stack([rks ** j for j in range(p)])
                rhos_p = np.linalg.solve(R[:-1, :-1], b[:-1])
        pred_a[i] = (s_t / s_s0) if s_s0 > 0 else 0.0
        # m0 = m_i goes to hist slot 0 after the shift
        pred_m[i, 0] = -a_t * h_phi_1 + a_t * b_h * sum(
            rhos_p[k - 1] / rks[k - 1] for k in range(1, p))
        for k in range(1, p):
            pred_m[i, k] = -a_t * b_h * rhos_p[k - 1] / rks[k - 1]

    if timesteps is None:
        timesteps = np.floor(sigmas[:-1] * 1000.0)
    return SolverCoeffs(
        sigma=sigma_c, has_corr=has_corr, corr_a=corr_a, corr_mt=corr_mt,
        corr_m=corr_m, pred_a=pred_a, pred_m=pred_m,
        timesteps=np.asarray(timesteps, dtype=np.float64))


def unipc_init_state(latents: torch.Tensor, order: int = 2):
    """Solver state: sample, last_sample and `order` history slots, fp32."""
    x = latents.float()
    return {
        "sample": x,
        "last_sample": torch.zeros_like(x),
        "hist": torch.zeros((order,) + tuple(x.shape), dtype=torch.float32,
                            device=x.device),
    }


def _combine(coeffs, hist):
    out = None
    for c, h in zip(coeffs, hist):
        out = c * h if out is None else out + c * h
    return out


def unipc_step(state, c, velocity: torch.Tensor):
    """One UniPC step (corrector for the previous step + predictor); `c` is
    SolverCoeffs.step(i)."""
    x = state["sample"]
    v = velocity.float()
    m = x - c["sigma"] * v
    hist = state["hist"]
    if c["has_corr"] > 0:
        sample = (c["corr_a"] * state["last_sample"] + c["corr_mt"] * m
                  + _combine(c["corr_m"], hist))
    else:
        sample = x
    new_hist = torch.cat([m[None], hist[:-1]], dim=0)
    new_sample = c["pred_a"] * sample + _combine(c["pred_m"], new_hist)
    return {"sample": new_sample, "last_sample": sample, "hist": new_hist}


# ---------------------------------------------------------------------------
# DPM-Solver++ (multistep, order<=3) — same precomputed-coefficient treatment
# ---------------------------------------------------------------------------


def precompute_dpm_solver(sigmas: np.ndarray, solver_order: int = 2,
                          lower_order_final: bool = True,
                          timesteps: Optional[np.ndarray] = None
                          ) -> SolverCoeffs:
    """DPM-Solver++ multistep (reference fm_solvers.py, dpmsolver++ branch).

    Step i, order 1:  x_{i+1} = (s_t/s_s)x - a_t(e^{-h}-1) m_i
    Step i, order 2:  ... - a_t(e^{-h}-1)[m_i + 0.5 r (m_i - m_{i-1})],
        r = h_{i-1}/h ... expressed here via D0/D1 form:
        x_{i+1} = (s_t/s_s)x - a_t(e^{-h}-1)D0 - 0.5 a_t(e^{-h}-1)D1
        D0 = m_i, D1 = (m_i - m_{i-1})/r0 with r0 = h_{i-1}/h.
    Reuses SolverCoeffs with has_corr = 0 everywhere.
    """
    sigmas = np.asarray(sigmas, dtype=np.float64)
    num_steps = sigmas.shape[0] - 1
    K = solver_order
    lam = np.array([_lam(s) for s in sigmas])
    alpha = 1.0 - sigmas

    orders = []
    lower = 0
    for i in range(num_steps):
        o = min(solver_order, num_steps - i) if lower_order_final \
            else solver_order
        o = min(o, lower + 1)
        orders.append(o)
        lower = min(lower + 1, solver_order)

    pred_a = np.zeros(num_steps)
    pred_m = np.zeros((num_steps, K))
    for i in range(num_steps):
        p = orders[i]
        s_t, s_s0 = sigmas[i + 1], sigmas[i]
        a_t = alpha[i + 1]
        h = lam[i + 1] - lam[i]
        phi = math.expm1(-h)
        pred_a[i] = (s_t / s_s0) if s_s0 > 0 else 0.0
        if p == 1:
            pred_m[i, 0] = -a_t * phi
        elif p == 2:
            h0 = lam[i] - lam[i - 1]
            r0 = h0 / h
            # x = A x - a_t phi D0 - 0.5 a_t phi D1;  D1 = (m_i - m_{i-1})/r0
            pred_m[i, 0] = -a_t * phi * (1.0 + 0.5 / r0)
            pred_m[i, 1] = a_t * phi * 0.5 / r0
        else:
            # third order (fm_solvers.py:641-673):
            #   x = A x - a_t phi1 D0 + a_t (phi1/h + 1) D1
            #       - a_t ((phi1 + h)/h^2 - 1/2) D2
            # with D1 = (1+g) D1_0 - g D1_1, g = r0/(r0+r1),
            #      D2 = (D1_0 - D1_1)/(r0+r1),
            #      D1_0 = (m0-m1)/r0, D1_1 = (m1-m2)/r1
            # expanded to per-history coefficients on (m0, m1, m2).
            h0 = lam[i] - lam[i - 1]
            h1 = lam[i - 1] - lam[i - 2]
            r0, r1 = h0 / h, h1 / h
            g = r0 / (r0 + r1)
            b0 = -a_t * phi
            b1 = a_t * (phi / h + 1.0)
            b2 = -a_t * ((phi + h) / h ** 2 - 0.5)
            d1_m0 = (1.0 + g) / r0
            d1_m1 = -((1.0 + g) / r0 + g / r1)
            d1_m2 = g / r1
            d2_m0 = 1.0 / ((r0 + r1) * r0)
            d2_m1 = -(1.0 / ((r0 + r1) * r0) + 1.0 / ((r0 + r1) * r1))
            d2_m2 = 1.0 / ((r0 + r1) * r1)
            pred_m[i, 0] = b0 + b1 * d1_m0 + b2 * d2_m0
            pred_m[i, 1] = b1 * d1_m1 + b2 * d2_m1
            pred_m[i, 2] = b1 * d1_m2 + b2 * d2_m2
    if timesteps is None:
        timesteps = np.floor(sigmas[:-1] * 1000.0)
    zeros = np.zeros(num_steps)
    return SolverCoeffs(
        sigma=sigmas[:-1].copy(), has_corr=zeros, corr_a=zeros,
        corr_mt=zeros, corr_m=np.zeros((num_steps, K)), pred_a=pred_a,
        pred_m=pred_m, timesteps=np.asarray(timesteps, dtype=np.float64))


def dpm_init_state(latents: torch.Tensor, order: int = 2):
    """DPM++ state: UniPC's layout (sample, last_sample, history)."""
    return unipc_init_state(latents, order)


def dpm_step(state, c, velocity: torch.Tensor):
    """DPM++ multistep update (no corrector); same state layout as UniPC."""
    x = state["sample"]
    v = velocity.float()
    m = x - c["sigma"] * v
    new_hist = torch.cat([m[None], state["hist"][:-1]], dim=0)
    new_sample = c["pred_a"] * x + _combine(c["pred_m"], new_hist)
    return {"sample": new_sample, "last_sample": x, "hist": new_hist}


def euler_flow_step(x: torch.Tensor, velocity: torch.Tensor,
                    sigma_cur: float, sigma_next: float) -> torch.Tensor:
    """x' = x + (sigma_next - sigma_cur) * v  == x - v*dt for t: 1 -> 0
    (BAGEL's image flow step)."""
    return x + (sigma_next - sigma_cur) * velocity.to(x.dtype)


def add_flow_noise(x0: torch.Tensor, noise: torch.Tensor, sigma
                   ) -> torch.Tensor:
    """x_t = (1 - sigma) x0 + sigma * noise, sigma in x0's dtype and
    broadcast from the left (univid_tpu/ops/samplers.py::add_flow_noise)."""
    sigma = torch.as_tensor(sigma, device=x0.device).to(x0.dtype)
    while sigma.ndim < x0.ndim:
        sigma = sigma[..., None]
    return (1.0 - sigma) * x0 + sigma * noise
