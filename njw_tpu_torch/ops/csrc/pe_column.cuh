// The primitive-equation column arithmetic: the scalars shared by the stage
// kernel (pe_stage.cu) and the whole-step kernel (pe_rk4.cu), and the stage
// kernel's arithmetic at one level of a column.
//
// The arithmetic is the Pallas kernels' strength-reduced form
// (njw_tpu/ops/pe_stencil.py, _pe_stage_kernel and _pe_tend_values):
//   * a top-down pass accumulates the per-level flux divergence
//     div(ps u_k) into the cumulative list cum_k and its total (dps);
//   * a bottom-up pass carries the hydrostatic geopotential phi at the four
//     side neighbours and the lower-interface sigma-dot, so neither is
//     stored per level;
//   * sigma-dot is pre-scaled by L/2: sd_k = -0.5 (k dps/ps + cum_{k-1}/ps);
//   * omega/p uses (sd_up + sd_dn) * 1/(k + 1/2) + D lnps/Dt.
// The stencil needs only the four side neighbours (no corners). Where the
// values come from, and the walk over the levels, is the kernel's.
#pragma once

#include <cuda_runtime.h>

namespace pe {

// Scalars folded in double on the host and rounded to float32 once.
struct Consts {
    float cx, cy;        // 0.5/dx, 0.5/dy
    float f;             // Coriolis parameter
    float dsig;          // 1/L
    float r_dry, kappa;
    float phibot;        // R ln(1/sig_{L-1})
};

// A field at one level around a column: the centre and its four side
// neighbours (east +x, west -x, north +y, south -y).
struct Cross {
    float c, e, w, n, s;
};

// The flux divergence d(ps u)/dx + d(ps v)/dy at one level.
__device__ __forceinline__ float flux_divergence(const Cross& ps, float uE,
                                                 float uW, float vN, float vS,
                                                 const Consts& k) {
    return (ps.e * uE - ps.w * uW) * k.cx + (ps.n * vN - ps.s * vS) * k.cy;
}

// What the bottom-up pass needs of the whole column.
struct ColumnTerms {
    float lnps_x, lnps_y;   // d ln ps / dx, dy
    float dps_over_ps;      // dps / ps
};

// The tendencies (du, dv, dT, dq) at one level: u, v, T, q around the
// column at this level, the centres one level up (hi: kk - 1) and down
// (lo: kk + 1), phi's differences across the column, sigma-dot at the
// interfaces above (sd_up) and below (sd_dn), 1/(k + 1/2), and whether this
// is the top or the bottom level.
struct Tendency {
    float du, dv, dT, dq;
};

__device__ __forceinline__ Tendency level_tendency(
    const Cross& u, const Cross& v, const Cross& T, const Cross& q,
    float u_hi, float v_hi, float T_hi, float q_hi, float u_lo, float v_lo,
    float T_lo, float q_lo, float phi_x, float phi_y, float sd_up,
    float sd_dn, float inv_kh, bool top, bool bottom, const ColumnTerms& col,
    const Consts& k) {
    const float uk = u.c, vk = v.c, Tk = T.c, qk = q.c;
    const float u_x = (u.e - u.w) * k.cx;
    const float u_y = (u.n - u.s) * k.cy;
    const float v_x = (v.e - v.w) * k.cx;
    const float v_y = (v.n - v.s) * k.cy;
    const float T_x = (T.e - T.w) * k.cx;
    const float T_y = (T.n - T.s) * k.cy;
    const float q_x = (q.e - q.w) * k.cx;
    const float q_y = (q.n - q.s) * k.cy;

    const float u_up = top ? 0.0f : uk - u_hi;
    const float u_dn = bottom ? 0.0f : u_lo - uk;
    const float v_up = top ? 0.0f : vk - v_hi;
    const float v_dn = bottom ? 0.0f : v_lo - vk;
    const float T_up = top ? 0.0f : Tk - T_hi;
    const float T_dn = bottom ? 0.0f : T_lo - Tk;
    const float q_up = top ? 0.0f : qk - q_hi;
    const float q_dn = bottom ? 0.0f : q_lo - qk;
    const float vadv_u = sd_dn * u_dn + sd_up * u_up;
    const float vadv_v = sd_dn * v_dn + sd_up * v_up;
    const float vadv_T = sd_dn * T_dn + sd_up * T_up;
    const float vadv_q = sd_dn * q_dn + sd_up * q_up;

    Tendency d;
    d.du = -uk * u_x - vk * u_y - vadv_u + k.f * vk - phi_x
           - k.r_dry * Tk * col.lnps_x;
    d.dv = -uk * v_x - vk * v_y - vadv_v - k.f * uk - phi_y
           - k.r_dry * Tk * col.lnps_y;
    const float dlnps_adv = col.dps_over_ps + uk * col.lnps_x
                            + vk * col.lnps_y;
    const float omega_over_p = (sd_up + sd_dn) * inv_kh + dlnps_adv;
    d.dT = -uk * T_x - vk * T_y - vadv_T + k.kappa * Tk * omega_over_p;
    d.dq = -uk * q_x - vk * q_y - vadv_q;
    return d;
}

}  // namespace pe
