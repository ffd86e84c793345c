// K5 launch: RFC 9380 hash-to-G2 (BLS12381G2_XMD:SHA-256_SSWU_RO_) from
// field elements, a warp per message.
//
// Replaces, in the JAX package (lighthouse_tpu/ops/bls381_htc.py), :311
// hash_to_g2_device with :267 map_to_curve_sswu_device (and :169
// f2_sqrt_device, :215 f2_sgn0_device), :295 isogeny_to_e2_device, the
// pair add, and the cofactor clearing of bls381_pairing.py:440. The host
// keeps expand_message_xmd (messages_to_field_device, :329), as in JAX.
//
// Design: no inversion anywhere, and the chain of one message cut short.
//   1. Lanes 0 and 1 of the message's warp run its two simplified-SWU
//      maps side by side (RFC 9380 6.6.2 with x = x_num / x_den, the
//      CMOV for tv2 = 0), every branch a select, so the two lanes stay in
//      step. gx1 = U / V is never divided: its root comes from the complex
//      method on W = U conj(V) and M = norm(V), a = W / M, with two Fq
//      powers and no inverse: n = N(W)^((p+1)/4) settles whether gx1 is a
//      square; if not, the map takes the root of Z gx1 instead (W -> Z W,
//      n -> sqrt(-5) n, RFC 9380's sqrt_ratio convention), so one power
//      serves both candidates and no lane takes another path; then
//      g = (delta M)^((p-3)/4) with delta = (W0 + n) / 2 gives both
//      sqrt(delta) and 1 / sqrt(delta) up to a common sign:
//      root = (delta g, W1 g / 2), or (W1 g / 2, -delta g) when delta is
//      not a square, and the sign is then fixed by sgn0 as the RFC fixes
//      it. The affine y comes out directly; the point goes on as the
//      Jacobian (x_num x_den, y x_den^3, x_den). The powers run 4-bit
//      fixed windows (376 squarings and at most 94 products each).
//   2. The warp then works as a team (K4's model, bls381_pairing.cu): the
//      state lives in shared memory and each round puts up to eight Fq2
//      products on its lanes, four Fq products each (schoolbook: no sums
//      before the products), one a lane. A lane writes its two Fq
//      operands into shared memory (a coordinate picked by reference, or
//      of a sum), multiplies, and two lanes an Fq2 form its coordinates
//      with one subtraction each, so a round costs about one Fq product
//      and a few additions. On E' the two points are added (general-a
//      Jacobian addition, 6 rounds; P == Q doubles with a = 240u), then
//      the 3-isogeny maps the sum once (it is a homomorphism) in
//      projective form: x' = X'/Z'^2, D = X' - x0 Z'^2,
//      X = X' D^2 + T D Z'^4 + U Z'^6, Y = -Y' (D^3 - T D Z'^4 - 2U Z'^6),
//      Z = 3 D Z' (the host oracle's Velu form with 1/9 and 1/27 folded
//      into Z), 5 rounds. Then [h_eff] by Budroni-Pintore: two |x|-ladders
//      (63 doublings of 3 rounds, 5 additions of 6), psi and the last
//      additions, every step the formula of curve.py's pt_double and
//      pt_add, so the output equals the plain version limb for limb.
// Products are mont_mul_cs (mont_cs.cuh) on registers, not the shared
// fp_mul; a team lane's product is one out-of-line copy (fq_mul1).
// Longest dependent chain: a map (two powers, ~2 x 470 products, and ~40
// more), then ~480 team rounds of one product each.
//
// What bounds it: 32-bit multiply-adds. The bound counts the least Fq
// multiplications per message from the cheapest known way to compute the
// function, whatever this kernel does: SSWU and the isogeny in
// projective form need no inversion, and a power to a fixed e is counted
// at the floor of any addition chain, ceil(log2 e) steps (379 for
// (p-3)/4).
//   * per SSWU map (two per message): u^2, tv1^2, tv3^2, tv4^2 (8), g(x)'s
//     numerator and denominator and the radicand g_n * x_d (9), X and Y
//     (6); the root of the radicand by the complex method without an
//     inverse: its norm (2), two Fq powers by (p-3)/4 (758) and 4
//     products: 787. (The non-square case adds a few products; the
//     count takes the square one. RFC 9380's sqrt_ratio, one Fq2 power of
//     757 steps, would be at least 1,514.)
//   * the sum of the two points on E' (43), then one isogeny, since it is
//     a homomorphism (32 Fq2 products and 3 squares: 102).
//   * cofactor clearing (RFC 9380 G.3): two |x|-ladders on Jacobian points
//     (63 doublings, 16, and 5 additions, 43: 1,223 each), a doubling, 5
//     additions, psi (5) and psi^2 (2): 2,684.
//   4,403 per message (BLS_FQ_MULS in chip_smoke.py).
#include "bls381_field.cuh"
#include "mont_cs.cuh"

// sqrt(-5) (Montgomery): a root of norm(Z) N(W) = 5 N(W) from n^2 = -N(W)
CONSTMEM uint32_t BLS_SQRT_M5[12] = {0x7f49f0bau, 0xcd94f740u, 0xa6c4f72du, 0xe4f81e0fu, 0x4799eedbu, 0x30e77d85u,
                                     0xde13f299u, 0xc442e208u, 0x5facaabeu, 0x15a4f8f7u, 0xe164a855u, 0x135bd2bfu};
// (p - 3) / 4 (plain); BLS_SQRT_EXP is (p + 1) / 4
CONSTMEM uint32_t BLS_SQRT_EXP_M1[12] = {0xffffeaaau, 0xee7fbfffu, 0xac54ffffu, 0x07aaffffu, 0x3dac3d89u, 0xd9cc34a8u,
                                         0x3ce144afu, 0xd91dd2e1u, 0x90d2eb35u, 0x92c6e9edu, 0x8e5ff9a6u, 0x0680447au};

// ---------------------------------------------------------------------------
// Fq and Fq2 on the column-sum product
// ---------------------------------------------------------------------------

DEV void fq_mulx(fp& r, const fp& a, const fp& b) { mont_mul_cs<12>(r.v, a.v, b.v, BLS_P, BLS_NINV); }

// one out-of-line copy for the products that stand alone (a team lane's,
// the map's single ones): the inlined copies stay where they interleave
DEVNI void fq_mul1(fp& r, const fp& a, const fp& b) { fq_mulx(r, a, b); }

// Karatsuba: three independent products, interleaved by the compiler
DEVNI void fq2_mulx(fp2& r, const fp2& a, const fp2& b) {
  fp t0, t1, x, sa, sb;
  fp_add(sa, a.c0, a.c1);
  fp_add(sb, b.c0, b.c1);
  fq_mulx(t0, a.c0, b.c0);
  fq_mulx(t1, a.c1, b.c1);
  fq_mulx(x, sa, sb);
  fp_sub(r.c0, t0, t1);
  fp_sub(x, x, t0);
  fp_sub(r.c1, x, t1);
}

DEVNI void fq2_sqrx(fp2& r, const fp2& a) {
  fp s, d, t, c0;
  fp_add(s, a.c0, a.c1);
  fp_sub(d, a.c0, a.c1);
  fq_mulx(c0, s, d);
  fq_mulx(t, a.c0, a.c1);
  r.c0 = c0;
  fp_add(r.c1, t, t);
}

DEV void fq_sel(fp& r, bool c, const fp& a, const fp& b) { UNROLL for (int j = 0; j < 12; j++) r.v[j] = c ? a.v[j] : b.v[j]; }
DEV void fq2_sel(fp2& r, bool c, const fp2& a, const fp2& b) { fq_sel(r.c0, c, a.c0, b.c0); fq_sel(r.c1, c, a.c1, b.c1); }

#ifdef __CUDACC__
#define NO_UNROLL _Pragma("unroll 1")
#else
#define NO_UNROLL
#endif

// a^e for a plain 12-word exponent, 4-bit fixed windows from the top
// nonzero one: 4 squarings a window and a product by a^digit if nonzero.
// Loops stay rolled: three inlined products in all, not one a step.
DEVNI void fq_pow_win(fp& r, const fp& a, const uint32_t* e) {
  fp tab[16];
  fp_one(tab[0]);
  tab[1] = a;
  NO_UNROLL for (int i = 2; i < 16; i++) fq_mulx(tab[i], tab[i - 1], a);
  int top = 95;
  while (!((e[top >> 3] >> (4 * (top & 7))) & 15u)) top--;
  fp acc = tab[(e[top >> 3] >> (4 * (top & 7))) & 15u];
  NO_UNROLL for (int i = top - 1; i >= 0; i--) {
    NO_UNROLL for (int s = 0; s < 4; s++) fq_mulx(acc, acc, acc);
    const uint32_t d = (e[i >> 3] >> (4 * (i & 7))) & 15u;
    if (d) fq_mulx(acc, acc, tab[d]);
  }
  r = acc;
}

// RFC 9380 sgn0 for m = 2, on canonical values
DEV int fq2_sgn0x(const fp2& a) {
  fp one, c0, c1;
  fp_zero(one);
  one.v[0] = 1;
  fq_mul1(c0, a.c0, one);
  fq_mul1(c1, a.c1, one);
  return (int)(c0.v[0] & 1u) | ((int)fp_is_zero(c0) & (int)(c1.v[0] & 1u));
}

// ---------------------------------------------------------------------------
// 1. The simplified SWU map of u onto E', no inversion, every branch a select
// ---------------------------------------------------------------------------

// Inlined into the kernel. Compiled out of line (__noinline__; sm_90a,
// nvcc 12.9) it returns a wrong y on the card, also in a kernel of one
// thread per map with no shared memory, and also with ptxas at -O0; with
// -G, inlined, and on the host (under ASan and UBSan, not inlined) it
// agrees with the plain version. analysis/htc_outline_probe.py rebuilds
// those variants.
DEV void map_to_curve_sswu_jac(jac<fp2>& q, const fp2& u) {
  fp2 c, t, tv1, tv2, tv3, tv4, tv6, un, w, zw, y1, y;
  fq2_sqrx(tv1, u);
  fp2_const(c, BLS_SSWU_Z);
  fq2_mulx(tv1, c, tv1);                 // Z u^2
  fq2_sqrx(tv2, tv1);
  fp2_add(tv2, tv2, tv1);                // Z^2 u^4 + Z u^2
  fp2_one(t);
  fp2_add(tv3, tv2, t);
  fp2_const(c, BLS_SSWU_B);
  fq2_mulx(tv3, c, tv3);                 // x_num = B (tv2 + 1)
  fp2_neg(t, tv2);
  fp2_const(c, BLS_SSWU_Z);
  fq2_sel(tv4, fp2_is_zero(tv2), c, t);  // CMOV(Z, -tv2, tv2 != 0)
  fp2_const(c, BLS_SSWU_A);
  fq2_mulx(tv4, c, tv4);                 // x_den = A (-tv2 or Z)
  // gx1 = U / V with U = x_num^3 + A x_num x_den^2 + B x_den^3, V = x_den^3
  fq2_sqrx(tv6, tv4);
  fq2_mulx(t, c, tv6);
  fq2_sqrx(un, tv3);
  fp2_add(un, un, t);
  fq2_mulx(un, un, tv3);
  fq2_mulx(tv6, tv6, tv4);               // V
  fp2_const(c, BLS_SSWU_B);
  fq2_mulx(t, c, tv6);
  fp2_add(un, un, t);                    // U
  // the complex method on a = U / V = W / M
  fp m, nw, n, s, cn, delta, d2, h, g, tt, cc, one;
  fp2_conj(t, tv6);
  fq2_mulx(w, un, t);
  fq_mul1(m, tv6.c0, tv6.c0);
  fq_mul1(s, tv6.c1, tv6.c1);
  fp_add(m, m, s);
  fq_mul1(nw, w.c0, w.c0);
  fq_mul1(s, w.c1, w.c1);
  fp_add(nw, nw, s);
  fq_pow_win(n, nw, BLS_SQRT_EXP);       // N(W)^((p+1)/4)
  fq_mul1(s, n, n);
  const bool is_sq = fp_eq(s, nw);
  fp2_const(c, BLS_SSWU_Z);
  fq2_mulx(zw, c, w);
  fp_const(s, BLS_SQRT_M5);
  fq_mul1(cn, s, n);
  fq2_sel(w, is_sq, w, zw);
  fq_sel(n, is_sq, n, cn);
  fp_add(delta, w.c0, n);
  fp_half(delta, delta);
  fp_sub(d2, w.c0, n);
  fp_half(d2, d2);
  fq_sel(delta, fp_is_zero(delta), d2, delta);
  fq_mul1(h, delta, m);
  fq_pow_win(g, h, BLS_SQRT_EXP_M1);     // (delta M)^((p-3)/4)
  fq_mul1(s, g, g);
  fq_mul1(s, s, h);
  fp_one(one);
  const bool delta_sq = fp_eq(s, one);
  fq_mul1(tt, delta, g);
  fq_mul1(cc, w.c1, g);
  fp_half(cc, cc);
  fp_neg(s, tt);
  fq_sel(y1.c0, delta_sq, tt, cc);
  fq_sel(y1.c1, delta_sq, cc, s);
  // y = y1, or tv1 u y1 (the root of gx2 = tv1^3 gx1); x_num, or tv1 x_num
  fq2_mulx(t, tv1, u);
  fq2_mulx(t, t, y1);
  fq2_sel(y, is_sq, y1, t);
  fq2_mulx(t, tv1, tv3);
  fq2_sel(tv3, is_sq, tv3, t);
  fp2_neg(t, y);
  fq2_sel(y, fq2_sgn0x(u) == fq2_sgn0x(y), y, t);
  // Jacobian (x_num x_den, y x_den^3, x_den)
  fq2_mulx(q.x, tv3, tv4);
  fq2_mulx(q.y, y, tv6);
  q.z = tv4;
}

// ---------------------------------------------------------------------------
// 2. Team rounds on a warp: points and named values in shared memory
// ---------------------------------------------------------------------------

#define HTC_TEAM 32
#define HTC_SLOTS 16

struct HTeam {
  int lane;
  fp* opa;   // [32]: a round's operands, one pair a lane
  fp* opb;
  fp* prod;  // [32]: a round's Fq products, one a lane
  fp2* v;    // [HTC_SLOTS]: the rounds' results, by slot
#ifdef __CUDACC__
  __device__ void sync() const { __syncwarp(); }
#else
  void sync() const {}  // host builds run one lane: nothing to wait for
#endif
};

// coordinate i of an Fq2
DEV const fp& cpt(const fp2& a, int i) { return i ? a.c1 : a.c0; }

// One round: v[base + q] = x_q * y_q for q < n <= 8, each Fq2 product as
// four Fq products x_i y_j on lanes 4q + 2i + j (schoolbook: no sums
// before the products). sel(q, i, j, a, b) writes the lane's operands x_i
// and y_j into shared memory (a reference picked, or a coordinate of a
// sum), the product reads them there. The x_1 y_0 lane negates its
// product, so both coordinates come out of one subtraction on two lanes:
// x0 y0 - x1 y1 and x0 y1 - (-x1 y0).
template <class Sel>
DEV void team_round(const HTeam& tm, int n, int base, Sel sel) {
  const int k = tm.lane;
  if (k < 4 * n) {
    sel(k >> 2, (k >> 1) & 1, k & 1, tm.opa[k], tm.opb[k]);
    fq_mul1(tm.prod[k], tm.opa[k], tm.opb[k]);
    if ((k & 3) == 2) fp_neg(tm.prod[k], tm.prod[k]);
  }
  tm.sync();
  if (k < 2 * n) {
    const int q = k >> 1, c = k & 1;
    fp_sub(c ? tm.v[base + q].c1 : tm.v[base + q].c0, tm.prod[4 * q + c], tm.prod[4 * q + 3 - c]);
  }
  tm.sync();
}

DEV void team_copy(const HTeam& tm, jac<fp2>& r, const jac<fp2>& p) {
  if (tm.lane == 0) r.x = p.x;
  if (tm.lane == 1) r.y = p.y;
  if (tm.lane == 2) r.z = p.z;
  tm.sync();
}

DEV void team_neg(const HTeam& tm, jac<fp2>& r, const jac<fp2>& p) {
  if (tm.lane == 0) r.x = p.x;
  if (tm.lane == 1) fp2_neg(r.y, p.y);
  if (tm.lane == 2) r.z = p.z;
  tm.sync();
}

DEV void team_inf(const HTeam& tm, jac<fp2>& r) {
  if (tm.lane == 0) fp2_one(r.x);
  if (tm.lane == 1) fp2_one(r.y);
  if (tm.lane == 2) fp2_zero(r.z);
  tm.sync();
}

// 2P (curve.py pt_double; r may be p): 3 rounds. With a_coef, the
// general-a form on E' (E = 3 X^2 + a Z^4): 5 rounds.
DEVNI void team_dbl(const HTeam& tm, jac<fp2>& r, const jac<fp2>& p, bool a_coef) {
  fp2* v = tm.v;
  // slots: A 0, B 1, YZ 2, ZZ 3, C 4, T 5, F or Z4 6, aZ4 7, F 8, Y3 9
  team_round(tm, a_coef ? 4 : 3, 0, [&](int q, int i, int j, fp& a, fp& b) {
    const fp2& x = q == 0 ? p.x : q == 3 ? p.z : p.y;
    const fp2& y = q == 0 ? p.x : q == 1 ? p.y : p.z;
    a = cpt(x, i);
    b = cpt(y, j);
  });
  auto e_of = [&](fp& e, int i) {  // coordinate i of 3A (+ a Z^4)
    fp_add(e, cpt(v[0], i), cpt(v[0], i));
    fp_add(e, e, cpt(v[0], i));
    if (a_coef) fp_add(e, e, cpt(v[7], i));
  };
  // B^2, (X + B)^2, and E^2 (a = 0) or Z^4
  team_round(tm, 3, 4, [&](int q, int i, int j, fp& a, fp& b) {
    if (q == 1) {
      fp_add(a, cpt(p.x, i), cpt(v[1], i));
      fp_add(b, cpt(p.x, j), cpt(v[1], j));
    } else if (q == 2 && !a_coef) {
      e_of(a, i);
      e_of(b, j);
    } else {
      const fp2& x = q == 0 ? v[1] : v[3];
      a = cpt(x, i);
      b = cpt(x, j);
    }
  });
  const int f = a_coef ? 8 : 6;
  if (a_coef) {
    team_round(tm, 1, 7, [&](int, int i, int j, fp& a, fp& b) {
      fp_const(a, BLS_SSWU_A[i]);
      b = cpt(v[6], j);
    });
    team_round(tm, 1, 8, [&](int, int i, int j, fp& a, fp& b) {
      e_of(a, i);
      e_of(b, j);
    });
  }
  // coordinate i of D = 2 ((X + B)^2 - A - C) and of X3 = F - 2D
  auto d_x3 = [&](fp& d, fp& x3, int i) {
    fp_sub(d, cpt(v[5], i), cpt(v[0], i));
    fp_sub(d, d, cpt(v[4], i));
    fp_add(d, d, d);
    fp_add(x3, d, d);
    fp_sub(x3, cpt(v[f], i), x3);
  };
  team_round(tm, 1, 9, [&](int, int i, int j, fp& a, fp& b) {
    fp d, x3;
    e_of(a, i);
    d_x3(d, x3, j);
    fp_sub(b, d, x3);
  });
  // lanes 0-5: coordinate k % 2 of X3, Y3 = E (D - X3) - 8C, Z3 = 2 YZ
  const int k = tm.lane;
  if (k < 6) {
    const int i = k & 1;
    fp o, d, c8;
    if (k < 2) {
      d_x3(d, o, i);
      (i ? r.x.c1 : r.x.c0) = o;
    } else if (k < 4) {
      fp_add(c8, cpt(v[4], i), cpt(v[4], i));
      fp_add(c8, c8, c8);
      fp_add(c8, c8, c8);
      fp_sub(i ? r.y.c1 : r.y.c0, cpt(v[9], i), c8);
    } else {
      fp_add(i ? r.z.c1 : r.z.c0, cpt(v[2], i), cpt(v[2], i));
    }
  }
  tm.sync();
}

// P + Q with every case of curve.py pt_add (r may be p or q): an infinity
// operand passes the other through, P == Q doubles (general a on E'),
// P == -Q gives the canonical infinity. The branches are the team's own
// (every lane reads the same shared values).
DEVNI void team_add(const HTeam& tm, jac<fp2>& r, const jac<fp2>& p, const jac<fp2>& q, bool a_coef) {
  if (fp2_is_zero(p.z)) { team_copy(tm, r, q); return; }
  if (fp2_is_zero(q.z)) { team_copy(tm, r, p); return; }
  fp2* v = tm.v;
  // slots: Z1Z1 0, Z2Z2 1, U1 2, U2 3, T1 4, T2 5, S1 6, S2 7
  team_round(tm, 2, 0, [&](int k, int i, int j, fp& a, fp& b) {
    const fp2& z = k == 0 ? p.z : q.z;
    a = cpt(z, i);
    b = cpt(z, j);
  });
  team_round(tm, 4, 2, [&](int k, int i, int j, fp& a, fp& b) {
    const fp2& x = k == 0 ? p.x : k == 1 ? q.x : k == 2 ? v[1] : v[0];
    const fp2& y = k == 0 ? v[1] : k == 1 ? v[0] : k == 2 ? q.z : p.z;
    a = cpt(x, i);
    b = cpt(y, j);
  });
  team_round(tm, 2, 6, [&](int k, int i, int j, fp& a, fp& b) {
    a = cpt(k == 0 ? p.y : q.y, i);
    b = cpt(k == 0 ? v[4] : v[5], j);
  });
  if (fp2_eq(v[2], v[3])) {
    if (fp2_eq(v[6], v[7])) team_dbl(tm, r, p, a_coef); else team_inf(tm, r);
    return;
  }
  // coordinate i of H = U2 - U1 and rr = 2 (S2 - S1); slots: I 8, rr^2 9,
  // Z1Z2 10, J 11, V 12, Z1Z2H 13, rr (V - X3) 14, S1 J 15
  auto h_of = [&](fp& h, int i) { fp_sub(h, cpt(v[3], i), cpt(v[2], i)); };
  auto rr_of = [&](fp& rr, int i) {
    fp_sub(rr, cpt(v[7], i), cpt(v[6], i));
    fp_add(rr, rr, rr);
  };
  team_round(tm, 3, 8, [&](int k, int i, int j, fp& a, fp& b) {
    if (k == 0) {
      h_of(a, i);
      fp_add(a, a, a);
      h_of(b, j);
      fp_add(b, b, b);
    } else if (k == 1) {
      rr_of(a, i);
      rr_of(b, j);
    } else {
      a = cpt(p.z, i);
      b = cpt(q.z, j);
    }
  });
  team_round(tm, 3, 11, [&](int k, int i, int j, fp& a, fp& b) {
    if (k == 2) { a = cpt(v[10], i); h_of(b, j); }
    else { if (k == 0) h_of(a, i); else a = cpt(v[2], i); b = cpt(v[8], j); }
  });
  auto x3_of = [&](fp& x3, int i) {  // coordinate i of rr^2 - J - 2V
    fp t;
    fp_sub(x3, cpt(v[9], i), cpt(v[11], i));
    fp_add(t, cpt(v[12], i), cpt(v[12], i));
    fp_sub(x3, x3, t);
  };
  team_round(tm, 2, 14, [&](int k, int i, int j, fp& a, fp& b) {
    if (k == 0) {
      fp x3;
      rr_of(a, i);
      x3_of(x3, j);
      fp_sub(b, cpt(v[12], j), x3);
    } else {
      a = cpt(v[6], i);
      b = cpt(v[11], j);
    }
  });
  // lanes 0-5: coordinate k % 2 of X3, Y3 = rr (V - X3) - 2 S1 J, Z3 = 2 Z1Z2H
  const int k = tm.lane;
  if (k < 6) {
    const int i = k & 1;
    fp o;
    if (k < 2) {
      x3_of(o, i);
      (i ? r.x.c1 : r.x.c0) = o;
    } else if (k < 4) {
      fp_add(o, cpt(v[15], i), cpt(v[15], i));
      fp_sub(i ? r.y.c1 : r.y.c0, cpt(v[14], i), o);
    } else {
      fp_add(i ? r.z.c1 : r.z.c0, cpt(v[13], i), cpt(v[13], i));
    }
  }
  tm.sync();
}

// psi: (cx conj(X), cy conj(Y), conj(Z)); r may be p
DEVNI void team_psi(const HTeam& tm, jac<fp2>& r, const jac<fp2>& p) {
  team_round(tm, 2, 0, [&](int k, int i, int j, fp& a, fp& b) {
    const fp2& x = k == 0 ? p.x : p.y;
    if (i) fp_neg(a, x.c1); else a = x.c0;
    fp_const(b, k == 0 ? BLS_PSI_CX[j] : BLS_PSI_CY[j]);
  });
  if (tm.lane == 0) r.x = tm.v[0];
  if (tm.lane == 1) r.y = tm.v[1];
  if (tm.lane == 2) fp2_conj(r.z, p.z);
  tm.sync();
}

// [|x|]P from P over the bits of |x| below its top bit (r != p)
DEVNI void team_mul_x_abs(const HTeam& tm, jac<fp2>& r, const jac<fp2>& p) {
  team_copy(tm, r, p);
  for (int i = 62; i >= 0; i--) {
    team_dbl(tm, r, r, false);
    if ((BLS_X_ABS >> i) & 1) team_add(tm, r, r, p, false);
  }
}

// the 3-isogeny E' -> E2 in projective form (header, step 2); r != p
DEVNI void team_isogeny(const HTeam& tm, jac<fp2>& r, const jac<fp2>& p) {
  fp2* v = tm.v;
  // slots: ZZ 0, Z4 1, x0 ZZ 2, Z6 3, D^2 4, D Z4 5, D Z 6, X D^2 7,
  // T D Z4 8, U Z6 9, D^3 10, Y' inner 11
  auto d_of = [&](fp& d, int i) { fp_sub(d, cpt(p.x, i), cpt(v[2], i)); };
  team_round(tm, 1, 0, [&](int, int i, int j, fp& a, fp& b) {
    a = cpt(p.z, i);
    b = cpt(p.z, j);
  });
  team_round(tm, 2, 1, [&](int k, int i, int j, fp& a, fp& b) {
    if (k == 0) a = cpt(v[0], i); else fp_const(a, BLS_SSWU_X0[i]);
    b = cpt(v[0], j);
  });
  team_round(tm, 4, 3, [&](int k, int i, int j, fp& a, fp& b) {
    if (k == 0) a = cpt(v[1], i); else d_of(a, i);
    if (k == 1) d_of(b, j); else b = cpt(k == 0 ? v[0] : k == 2 ? v[1] : p.z, j);
  });
  team_round(tm, 4, 7, [&](int k, int i, int j, fp& a, fp& b) {
    if (k == 0) a = cpt(p.x, i);
    else if (k == 1) fp_const(a, BLS_SSWU_T[i]);
    else if (k == 2) fp_const(a, BLS_SSWU_U[i]);
    else d_of(a, i);
    b = cpt(k == 1 ? v[5] : k == 2 ? v[3] : v[4], j);
  });
  team_round(tm, 1, 11, [&](int, int i, int j, fp& a, fp& b) {
    a = cpt(p.y, i);
    fp_sub(b, cpt(v[10], j), cpt(v[8], j));
    fp_sub(b, b, cpt(v[9], j));
    fp_sub(b, b, cpt(v[9], j));
  });
  fp2 o;
  if (tm.lane == 0) {
    fp2_add(o, v[7], v[8]);
    fp2_add(r.x, o, v[9]);
  } else if (tm.lane == 1) {
    fp2_neg(r.y, v[11]);
  } else if (tm.lane == 2) {
    fp2_add(o, v[6], v[6]);
    fp2_add(r.z, o, v[6]);
  }
  tm.sync();
}

// [h_eff]Q = [x^2 - x - 1]Q + [x - 1]psi(Q) + psi^2(2Q) (Budroni-Pintore;
// curve.py g2_clear_cofactor with |x|-ladders in place of its wNAF, the
// steps of the plain g2_clear_cofactor16); s: 5 shared points of scratch
DEVNI void team_clear_cofactor(const HTeam& tm, jac<fp2>& r, const jac<fp2>& q, jac<fp2>* s) {
  jac<fp2>&a = s[0], &nq = s[1], &c1 = s[2], &c2 = s[3], &t = s[4];
  team_mul_x_abs(tm, a, q);
  team_neg(tm, a, a);               // [x]Q
  team_neg(tm, nq, q);
  team_add(tm, c1, a, nq, false);   // [x - 1]Q
  team_mul_x_abs(tm, c2, c1);
  team_neg(tm, c2, c2);             // [x^2 - x]Q
  team_add(tm, c2, c2, nq, false);  // [x^2 - x - 1]Q
  team_psi(tm, t, c1);
  team_add(tm, c2, c2, t, false);
  team_dbl(tm, t, q, false);
  team_psi(tm, t, t);
  team_psi(tm, t, t);
  team_add(tm, r, c2, t, false);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

// a warp per message: u [m, 2, 2, 12] -> out [m, 3, 2, 12]
__global__ void __launch_bounds__(HTC_TEAM)
hash_to_g2_kernel(const long long* u, long long* out) {
  __shared__ fp opa[HTC_TEAM], opb[HTC_TEAM], prod[HTC_TEAM];
  __shared__ fp2 slots[HTC_SLOTS];
  __shared__ jac<fp2> pts[8];
  const int lane = threadIdx.x;
  const long long i = blockIdx.x;
  const HTeam tm{lane, opa, opb, prod, slots};
  if (lane < 2) {
    fp2 uu;
    fp2_ld(uu, u + i * 48 + lane * 24);
    jac<fp2> q;
    map_to_curve_sswu_jac(q, uu);
    pts[lane] = q;
  }
  tm.sync();
  team_add(tm, pts[2], pts[0], pts[1], true);  // on E'
  team_isogeny(tm, pts[0], pts[2]);            // on E2
  team_clear_cofactor(tm, pts[1], pts[0], pts + 2);
  if (lane == 0) fp2_st(out + i * 72, pts[1].x);
  if (lane == 1) fp2_st(out + i * 72 + 24, pts[1].y);
  if (lane == 2) fp2_st(out + i * 72 + 48, pts[1].z);
}

extern "C" int bls_hash_to_g2(const long long* u, long long* out, long long m, void* stream) {
  hash_to_g2_kernel<<<(unsigned)m, HTC_TEAM, 0, (cudaStream_t)stream>>>(u, out);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
