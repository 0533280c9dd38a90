// The primitive-equation tendency of one (y, x) column, shared by the stage
// kernel (pe_stage.cu) and the whole-step kernel (pe_rk4.cu).
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
// The stencil needs only the four side neighbours (no corners).
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

// A column and its four side neighbours, as offsets into one plane.
struct Nbrs {
    size_t c, e, w, n, s;
};

// Loads from a field that no thread writes while the kernel runs take the
// read-only path; loads from a block's own scratch must not.
template <bool kReadOnly>
__device__ __forceinline__ float ld(const float* p) {
    if constexpr (kReadOnly) {
        return __ldg(p);
    } else {
        return *p;
    }
}

// The tendency of one column of the state (u, v, T, q: L planes of P
// floats each; ps: one plane). phis*: the surface geopotential at the four
// neighbours (0 without terrain). cum: L floats, `stride` apart. levc:
// thick[0..L), 1/(k + 1/2) for k < L. Calls emit.level(kk, du, dv, dT, dq)
// for kk = L-1 down to 0 and returns dps. kUnroll levels per trip of the
// bottom-up walk: more lets their loads overlap, at the cost of registers.
template <bool kReadOnly, int kUnroll, class Emit>
__device__ __forceinline__ float column_tendency(
    const float* u, const float* v, const float* T, const float* q,
    const float* ps, size_t P, const Nbrs& i, float phisE, float phisW,
    float phisN, float phisS, float* cum, int stride, const float* levc,
    int L, const Consts& k, Emit& emit) {
    const float psE = ld<kReadOnly>(ps + i.e), psW = ld<kReadOnly>(ps + i.w);
    const float psN = ld<kReadOnly>(ps + i.n), psS = ld<kReadOnly>(ps + i.s);
    const float psC = ld<kReadOnly>(ps + i.c);
    const float lnps_x = (logf(psE) - logf(psW)) * k.cx;
    const float lnps_y = (logf(psN) - logf(psS)) * k.cy;

    // top-down: flux divergence of (ps u, ps v), cumulative over levels
    float flux = 0.0f;
    for (int kk = 0; kk < L; ++kk) {
        const size_t o = kk * P;
        const float fd = (psE * ld<kReadOnly>(u + o + i.e)
                          - psW * ld<kReadOnly>(u + o + i.w)) * k.cx
                         + (psN * ld<kReadOnly>(v + o + i.n)
                            - psS * ld<kReadOnly>(v + o + i.s)) * k.cy;
        flux = kk == 0 ? fd : flux + fd;
        cum[kk * stride] = flux;
    }
    const float dps = -flux * k.dsig;
    const float inv_ps = 1.0f / psC;
    const float dps_over_ps = dps * inv_ps;

    // bottom-up: phi at the four neighbour columns, sigma-dot carried
    const size_t ob = (L - 1) * P;
    float phiE = k.phibot * ld<kReadOnly>(T + ob + i.e) + phisE;
    float phiW = k.phibot * ld<kReadOnly>(T + ob + i.w) + phisW;
    float phiN = k.phibot * ld<kReadOnly>(T + ob + i.n) + phisN;
    float phiS = k.phibot * ld<kReadOnly>(T + ob + i.s) + phisS;
    float sd_dn = 0.0f;
    float uk = ld<kReadOnly>(u + ob + i.c), vk = ld<kReadOnly>(v + ob + i.c);
    float Tk = ld<kReadOnly>(T + ob + i.c), qk = ld<kReadOnly>(q + ob + i.c);
    float u_lo = 0.0f, v_lo = 0.0f, T_lo = 0.0f, q_lo = 0.0f;  // level kk+1
#pragma unroll (kUnroll)
    for (int kk = L - 1; kk >= 0; --kk) {
        const size_t o = kk * P;
        const float sd_up = kk == 0 ? 0.0f
            : -0.5f * (static_cast<float>(kk) * dps_over_ps
                       + cum[(kk - 1) * stride] * inv_ps);
        float u_hi = 0.0f, v_hi = 0.0f, T_hi = 0.0f, q_hi = 0.0f;  // kk-1
        if (kk > 0) {
            u_hi = ld<kReadOnly>(u + o - P + i.c);
            v_hi = ld<kReadOnly>(v + o - P + i.c);
            T_hi = ld<kReadOnly>(T + o - P + i.c);
            q_hi = ld<kReadOnly>(q + o - P + i.c);
        }
        const float TE = ld<kReadOnly>(T + o + i.e);
        const float TW = ld<kReadOnly>(T + o + i.w);
        const float TN = ld<kReadOnly>(T + o + i.n);
        const float TS = ld<kReadOnly>(T + o + i.s);
        const float u_x = (ld<kReadOnly>(u + o + i.e)
                           - ld<kReadOnly>(u + o + i.w)) * k.cx;
        const float u_y = (ld<kReadOnly>(u + o + i.n)
                           - ld<kReadOnly>(u + o + i.s)) * k.cy;
        const float v_x = (ld<kReadOnly>(v + o + i.e)
                           - ld<kReadOnly>(v + o + i.w)) * k.cx;
        const float v_y = (ld<kReadOnly>(v + o + i.n)
                           - ld<kReadOnly>(v + o + i.s)) * k.cy;
        const float T_x = (TE - TW) * k.cx;
        const float T_y = (TN - TS) * k.cy;
        const float q_x = (ld<kReadOnly>(q + o + i.e)
                           - ld<kReadOnly>(q + o + i.w)) * k.cx;
        const float q_y = (ld<kReadOnly>(q + o + i.n)
                           - ld<kReadOnly>(q + o + i.s)) * k.cy;
        const float phi_x = (phiE - phiW) * k.cx;
        const float phi_y = (phiN - phiS) * k.cy;

        const bool top = kk == 0, bottom = kk == L - 1;
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

        const float du = -uk * u_x - vk * u_y - vadv_u + k.f * vk
                         - phi_x - k.r_dry * Tk * lnps_x;
        const float dv = -uk * v_x - vk * v_y - vadv_v - k.f * uk
                         - phi_y - k.r_dry * Tk * lnps_y;
        const float dlnps_adv = dps_over_ps + uk * lnps_x + vk * lnps_y;
        const float omega_over_p = (sd_up + sd_dn) * __ldg(levc + L + kk)
                                   + dlnps_adv;
        const float dT = -uk * T_x - vk * T_y - vadv_T
                         + k.kappa * Tk * omega_over_p;
        const float dq = -uk * q_x - vk * q_y - vadv_q;
        emit.level(kk, du, dv, dT, dq);

        if (kk > 0) {
            const float thick = __ldg(levc + kk);
            const size_t oh = o - P;
            phiE = phiE + thick * (ld<kReadOnly>(T + oh + i.e) + TE);
            phiW = phiW + thick * (ld<kReadOnly>(T + oh + i.w) + TW);
            phiN = phiN + thick * (ld<kReadOnly>(T + oh + i.n) + TN);
            phiS = phiS + thick * (ld<kReadOnly>(T + oh + i.s) + TS);
            sd_dn = sd_up;
            u_lo = uk; v_lo = vk; T_lo = Tk; q_lo = qk;
            uk = u_hi; vk = v_hi; Tk = T_hi; qk = q_hi;
        }
    }
    return dps;
}

}  // namespace pe
