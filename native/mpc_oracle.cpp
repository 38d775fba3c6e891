// Independent C++ reference solver for the box-constrained LTV-MPC QP.
//
// BASELINE.md parity check: the JAX framework's control sequences must match
// a reference C++ solve to <=1e-4.  This oracle follows the reference's own
// recipes — condensed QP assembly and a primal-dual interior-point solve in
// scalar double-precision C++ (the construction of mat_are_solver.hpp /
// quadratic_programs.hpp / mehrotra_method.hpp:269, re-implemented fresh) —
// sharing no code or numerical shortcuts with the JAX path, so agreement is
// evidence of correctness rather than of common bugs.
//
// I/O: little-endian binary.
//   input : int64 H, n, m
//           A (H*n*n), B (H*n*m), c (H*n), x0 (n),
//           Q (n*n), QN (n*n), R (m*m), lb (m), ub (m)     all float64
//   output: u (H*m) float64
// Build: g++ -O2 -std=c++17 mpc_oracle.cpp -o mpc_oracle
// Usage: mpc_oracle <in.bin> <out.bin>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <string_view>
#include <vector>

using std::vector;
typedef vector<double> Vec;

// dense column-major-free helpers (row-major throughout)
static void matmul(const double* A, const double* B, double* C, int n, int k,
                   int m) {  // C(n,m) = A(n,k) B(k,m)
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < m; ++j) {
      double s = 0;
      for (int t = 0; t < k; ++t) s += A[i * k + t] * B[t * m + j];
      C[i * m + j] = s;
    }
}

static void matvec(const double* A, const double* x, double* y, int n, int m) {
  for (int i = 0; i < n; ++i) {
    double s = 0;
    for (int j = 0; j < m; ++j) s += A[i * m + j] * x[j];
    y[i] = s;
  }
}

// Cholesky solve in place: A (N,N) SPD, b (N) -> x
static bool chol_solve(Vec A, Vec& b, int N) {
  for (int j = 0; j < N; ++j) {
    double d = A[j * N + j];
    for (int k = 0; k < j; ++k) d -= A[j * N + k] * A[j * N + k];
    if (d <= 0) return false;
    d = std::sqrt(d);
    A[j * N + j] = d;
    for (int i = j + 1; i < N; ++i) {
      double s = A[i * N + j];
      for (int k = 0; k < j; ++k) s -= A[i * N + k] * A[j * N + k];
      A[i * N + j] = s / d;
    }
  }
  for (int i = 0; i < N; ++i) {  // forward
    double s = b[i];
    for (int k = 0; k < i; ++k) s -= A[i * N + k] * b[k];
    b[i] = s / A[i * N + i];
  }
  for (int i = N - 1; i >= 0; --i) {  // backward (L^T)
    double s = b[i];
    for (int k = i + 1; k < N; ++k) s -= A[k * N + i] * b[k];
    b[i] = s / A[i * N + i];
  }
  return true;
}

// ---------------------------------------------------------------------------
// KTE mode (--kte): scalar C++ serial-chain forward dynamics + FD
// linearization, so the oracle consumes only (chain parameters, x0, weights)
// and builds its OWN LTV model — end-to-end parity per VERDICT r2 item 5
// (the reference's computeStateRate stack, manipulator_model.cpp:292-355,
// re-derived here via the Lagrangian/Christoffel route: M(q) from analytic
// Jacobians, Coriolis from central-difference Christoffel symbols, gravity
// from the potential gradient — a different algorithm from the JAX side's
// jvp-based assembly, so agreement checks the model, not shared math).
// ---------------------------------------------------------------------------

struct Quat {
  double w, x, y, z;
};
static Quat qmul(const Quat& a, const Quat& b) {
  return {a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
          a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}
static void qrot(const Quat& q, const double v[3], double out[3]) {
  // v + 2w(qv x v) + 2 qv x (qv x v)
  double t[3] = {2 * (q.y * v[2] - q.z * v[1]), 2 * (q.z * v[0] - q.x * v[2]),
                 2 * (q.x * v[1] - q.y * v[0])};
  out[0] = v[0] + q.w * t[0] + q.y * t[2] - q.z * t[1];
  out[1] = v[1] + q.w * t[1] + q.z * t[0] - q.x * t[2];
  out[2] = v[2] + q.w * t[2] + q.x * t[1] - q.y * t[0];
}
static void qrot_inv(const Quat& q, const double v[3], double out[3]) {
  Quat qc = {q.w, -q.x, -q.y, -q.z};
  qrot(qc, v, out);
}

struct Chain {
  int64_t nj;                  // joints (== dofs; revolute/prismatic only)
  vector<int64_t> jtype;       // 0 = revolute, 1 = prismatic
  vector<double> axis, off_pos, off_quat, com, mass, inertia;  // per joint
  vector<double> stiffness, rest_q, damping;
  double gravity[3];
};

// forward kinematics: world COM positions, body quats, anchors, world axes
static void fk(const Chain& ch, const double* q, double* coms, Quat* quats,
               double* anchors, double* axes_g) {
  double p[3] = {0, 0, 0};
  Quat Q = {1, 0, 0, 0};
  for (int64_t i = 0; i < ch.nj; ++i) {
    double tmp[3];
    qrot(Q, &ch.off_pos[3 * i], tmp);
    p[0] += tmp[0]; p[1] += tmp[1]; p[2] += tmp[2];
    const double* oq = &ch.off_quat[4 * i];
    Q = qmul(Q, {oq[0], oq[1], oq[2], oq[3]});
    qrot(Q, &ch.axis[3 * i], &axes_g[3 * i]);
    anchors[3 * i] = p[0]; anchors[3 * i + 1] = p[1]; anchors[3 * i + 2] = p[2];
    if (ch.jtype[i] == 0) {  // revolute: rotate about local axis
      double half = 0.5 * q[i], s = std::sin(half);
      const double* ax = &ch.axis[3 * i];
      Q = qmul(Q, {std::cos(half), ax[0] * s, ax[1] * s, ax[2] * s});
    } else {  // prismatic: translate along world axis
      p[0] += q[i] * axes_g[3 * i];
      p[1] += q[i] * axes_g[3 * i + 1];
      p[2] += q[i] * axes_g[3 * i + 2];
    }
    double pc[3];
    qrot(Q, &ch.com[3 * i], pc);
    coms[3 * i] = p[0] + pc[0];
    coms[3 * i + 1] = p[1] + pc[1];
    coms[3 * i + 2] = p[2] + pc[2];
    quats[i] = Q;
  }
}

// mass matrix M(q) = sum_b m_b Jv^T Jv + Jw^T I_b Jw  (analytic Jacobians)
static void mass_matrix(const Chain& ch, const double* q, double* M) {
  const int64_t nj = ch.nj;
  vector<double> coms(3 * nj), anchors(3 * nj), axes_g(3 * nj);
  vector<Quat> quats(nj);
  fk(ch, q, coms.data(), quats.data(), anchors.data(), axes_g.data());
  vector<double> Jv(nj * nj * 3, 0.0), Jw(nj * nj * 3, 0.0);
  for (int64_t b = 0; b < nj; ++b)
    for (int64_t k = 0; k <= b; ++k) {
      double* jv = &Jv[(b * nj + k) * 3];
      double* jw = &Jw[(b * nj + k) * 3];
      const double* ak = &axes_g[3 * k];
      if (ch.jtype[k] == 0) {
        double r[3] = {coms[3 * b] - anchors[3 * k],
                       coms[3 * b + 1] - anchors[3 * k + 1],
                       coms[3 * b + 2] - anchors[3 * k + 2]};
        jv[0] = ak[1] * r[2] - ak[2] * r[1];
        jv[1] = ak[2] * r[0] - ak[0] * r[2];
        jv[2] = ak[0] * r[1] - ak[1] * r[0];
        qrot_inv(quats[b], ak, jw);  // body-frame angular jacobian
      } else {
        jv[0] = ak[0]; jv[1] = ak[1]; jv[2] = ak[2];
      }
    }
  for (int64_t k = 0; k < nj; ++k)
    for (int64_t l = 0; l < nj; ++l) M[k * nj + l] = 0.0;
  for (int64_t b = 0; b < nj; ++b) {
    const double* I = &ch.inertia[9 * b];
    for (int64_t k = 0; k <= b; ++k)
      for (int64_t l = 0; l <= b; ++l) {
        const double* jk = &Jv[(b * nj + k) * 3];
        const double* jl = &Jv[(b * nj + l) * 3];
        double s = ch.mass[b] * (jk[0] * jl[0] + jk[1] * jl[1] + jk[2] * jl[2]);
        const double* wk = &Jw[(b * nj + k) * 3];
        const double* wl = &Jw[(b * nj + l) * 3];
        for (int r = 0; r < 3; ++r)
          for (int cc = 0; cc < 3; ++cc) s += wk[r] * I[r * 3 + cc] * wl[cc];
        M[k * nj + l] += s;
      }
  }
}

// potential V(q) = -sum_b m_b gravity . p_com_b
static double potential(const Chain& ch, const double* q) {
  const int64_t nj = ch.nj;
  vector<double> coms(3 * nj), anchors(3 * nj), axes_g(3 * nj);
  vector<Quat> quats(nj);
  fk(ch, q, coms.data(), quats.data(), anchors.data(), axes_g.data());
  double V = 0;
  for (int64_t b = 0; b < nj; ++b)
    V -= ch.mass[b] * (ch.gravity[0] * coms[3 * b] +
                       ch.gravity[1] * coms[3 * b + 1] +
                       ch.gravity[2] * coms[3 * b + 2]);
  return V;
}

// forward dynamics qdd = M^-1 (tau - C(q,qd)qd - dV/dq + passive)
// Coriolis via Christoffel symbols from central differences of M.
static void fwd_dyn(const Chain& ch, const double* q, const double* qd,
                    const double* tau, double* qdd, double* M_out = nullptr) {
  const int64_t nj = ch.nj;
  const double hM = 1e-5, hV = 1e-6;
  Vec M(nj * nj);
  mass_matrix(ch, q, M.data());
  // dM[k] = dM/dq_k (central)
  vector<Vec> dM(nj, Vec(nj * nj));
  Vec qp(q, q + nj), Mp(nj * nj), Mm(nj * nj);
  for (int64_t k = 0; k < nj; ++k) {
    qp[k] = q[k] + hM; mass_matrix(ch, qp.data(), Mp.data());
    qp[k] = q[k] - hM; mass_matrix(ch, qp.data(), Mm.data());
    qp[k] = q[k];
    for (int64_t i = 0; i < nj * nj; ++i) dM[k][i] = (Mp[i] - Mm[i]) / (2 * hM);
  }
  Vec f(nj);
  for (int64_t i = 0; i < nj; ++i) {
    // -(C qd)_i = -sum_jk Gamma_ijk qd_j qd_k,
    // Gamma_ijk = 0.5 (dM_ij/dq_k + dM_ik/dq_j - dM_jk/dq_i)
    double cv = 0;
    for (int64_t j = 0; j < nj; ++j)
      for (int64_t k = 0; k < nj; ++k)
        cv += 0.5 * (dM[k][i * nj + j] + dM[j][i * nj + k] -
                     dM[i][j * nj + k]) * qd[j] * qd[k];
    // gravity: -dV/dq_i (central)
    qp[i] = q[i] + hV; double Vp = potential(ch, qp.data());
    qp[i] = q[i] - hV; double Vm = potential(ch, qp.data());
    qp[i] = q[i];
    double gr = -(Vp - Vm) / (2 * hV);
    f[i] = tau[i] - cv + gr - ch.stiffness[i] * (q[i] - ch.rest_q[i]) -
           ch.damping[i] * qd[i];
  }
  Vec b = f;
  if (!chol_solve(M, b, (int)nj)) std::exit(3);
  for (int64_t i = 0; i < nj; ++i) qdd[i] = b[i];
  if (M_out) for (int64_t i = 0; i < nj * nj; ++i) M_out[i] = M[i];
}

// Build the LTV sequence with the SAME discretization recipe as the JAX path
// (frozen continuous linearization -> order-4 exponential series; the recipe
// is public math — all INGREDIENTS here are scalar C++ with FD derivatives):
//   A_c = [[0, I], [dqdd/dq, dqdd/dqd]]  (outer central differences),
//   B_c = [[0], [M^-1]],  S = sum dt^k A_c^{k-1}/k!,
//   Ad = I + A_c S, Bd = S B_c, x+ = x + S [qd; qdd].
static void kte_ltv_rollout(const Chain& ch, double dt, int64_t H,
                            const double* x0, Vec& A, Vec& B, Vec& c,
                            int order = 4) {
  const int64_t nj = ch.nj, n = 2 * nj;
  Vec x(x0, x0 + n), tau(nj, 0.0);
  A.assign(H * n * n, 0.0);
  B.assign(H * n * nj, 0.0);
  c.assign(H * n, 0.0);
  const double hx = 1e-3;  // FD-noise-optimal outer step (eps^(1/3) scale)
  for (int64_t t = 0; t < H; ++t) {
    Vec qdd(nj), M(nj * nj);
    fwd_dyn(ch, &x[0], &x[nj], tau.data(), qdd.data(), M.data());
    // A_c by outer central FD over all 2nj state directions
    Vec Ac(n * n, 0.0);
    for (int64_t i = 0; i < nj; ++i) Ac[i * n + nj + i] = 1.0;
    Vec xp = x, qp(nj), qm(nj);
    for (int64_t d2 = 0; d2 < n; ++d2) {
      xp[d2] = x[d2] + hx;
      fwd_dyn(ch, &xp[0], &xp[nj], tau.data(), qp.data());
      xp[d2] = x[d2] - hx;
      fwd_dyn(ch, &xp[0], &xp[nj], tau.data(), qm.data());
      xp[d2] = x[d2];
      for (int64_t i = 0; i < nj; ++i)
        Ac[(nj + i) * n + d2] = (qp[i] - qm[i]) / (2 * hx);
    }
    // B_c bottom block = M^-1 (columns by Cholesky solves)
    Vec Bc(n * nj, 0.0);
    for (int64_t j = 0; j < nj; ++j) {
      Vec e(nj, 0.0); e[j] = 1.0;
      Vec Mc = M;
      if (!chol_solve(Mc, e, (int)nj)) std::exit(3);
      for (int64_t i = 0; i < nj; ++i) Bc[(nj + i) * nj + j] = e[i];
    }
    // S = sum_{k=1..order} dt^k Ac^{k-1}/k!
    Vec S(n * n, 0.0), term(n * n, 0.0), nxt(n * n);
    for (int64_t i = 0; i < n; ++i) { S[i * n + i] = dt; term[i * n + i] = dt; }
    for (int k = 2; k <= order; ++k) {
      matmul(Ac.data(), term.data(), nxt.data(), (int)n, (int)n, (int)n);
      for (int64_t i = 0; i < n * n; ++i) term[i] = nxt[i] * (dt / k);
      for (int64_t i = 0; i < n * n; ++i) S[i] += term[i];
    }
    double* At = &A[t * n * n];
    double* Bt = &B[t * n * nj];
    matmul(Ac.data(), S.data(), At, (int)n, (int)n, (int)n);
    for (int64_t i = 0; i < n; ++i) At[i * n + i] += 1.0;
    matmul(S.data(), Bc.data(), Bt, (int)n, (int)n, (int)nj);
    Vec f0(n), dx(n);
    for (int64_t i = 0; i < nj; ++i) { f0[i] = x[nj + i]; f0[nj + i] = qdd[i]; }
    matvec(S.data(), f0.data(), dx.data(), (int)n, (int)n);
    Vec xn(n);
    for (int64_t i = 0; i < n; ++i) xn[i] = x[i] + dx[i];
    // c = x+ - Ad x - Bd u (u = 0 on the nominal)
    Vec Ax(n);
    matvec(At, x.data(), Ax.data(), (int)n, (int)n);
    for (int64_t i = 0; i < n; ++i) c[t * n + i] = xn[i] - Ax[i];
    x = xn;
  }
}

static int solve_condensed_qp(int64_t H, int64_t n, int64_t m, const Vec& A,
                              const Vec& B, const Vec& c, const Vec& x0,
                              const Vec& Q, const Vec& QN, const Vec& R,
                              const Vec& lb, const Vec& ub, Vec& u,
                              const Vec* xr = nullptr,
                              const Vec* ur = nullptr);

int main(int argc, char** argv) {
  bool kte_mode = argc == 4 && std::string_view(argv[1]) == "--kte";
  if (argc != 3 && !kte_mode) {
    std::fprintf(stderr, "usage: %s [--kte] in.bin out.bin\n", argv[0]);
    return 2;
  }
  const char* fin = kte_mode ? argv[2] : argv[1];
  const char* fout = kte_mode ? argv[3] : argv[2];
  FILE* f = std::fopen(fin, "rb");
  if (!f) return 2;
  auto rd = [&](int64_t cnt) {
    Vec v(cnt);
    if (std::fread(v.data(), 8, (size_t)cnt, f) != (size_t)cnt) std::exit(2);
    return v;
  };
  auto rdi = [&]() {
    int64_t v;
    if (std::fread(&v, 8, 1, f) != 1) std::exit(2);
    return v;
  };

  int64_t H, n, m;
  Vec A, B, c, x0, Q, QN, R, lb, ub, xref, uref;
  bool has_refs = false;
  if (kte_mode) {
    // input: int64 H, nj; double dt; per joint: int64 jtype; double axis[3],
    //        off_pos[3], off_quat[4], com[3], mass, inertia[9], stiffness,
    //        rest_q, damping; double gravity[3]; x0[2nj]; Q, QN, R, lb, ub
    H = rdi();
    Chain ch;
    ch.nj = rdi();
    double dt = rd(1)[0];
    n = 2 * ch.nj;
    m = ch.nj;
    for (int64_t i = 0; i < ch.nj; ++i) {
      ch.jtype.push_back(rdi());
      Vec ax = rd(3), op = rd(3), oq = rd(4), cm = rd(3);
      Vec ms = rd(1), in = rd(9), st = rd(1), rq = rd(1), dp = rd(1);
      ch.axis.insert(ch.axis.end(), ax.begin(), ax.end());
      ch.off_pos.insert(ch.off_pos.end(), op.begin(), op.end());
      ch.off_quat.insert(ch.off_quat.end(), oq.begin(), oq.end());
      ch.com.insert(ch.com.end(), cm.begin(), cm.end());
      ch.mass.push_back(ms[0]);
      ch.inertia.insert(ch.inertia.end(), in.begin(), in.end());
      ch.stiffness.push_back(st[0]);
      ch.rest_q.push_back(rq[0]);
      ch.damping.push_back(dp[0]);
    }
    Vec gv = rd(3);
    ch.gravity[0] = gv[0]; ch.gravity[1] = gv[1]; ch.gravity[2] = gv[2];
    x0 = rd(n);
    Q = rd(n * n); QN = rd(n * n); R = rd(m * m); lb = rd(m); ub = rd(m);
    std::fclose(f);
    kte_ltv_rollout(ch, dt, H, x0.data(), A, B, c);
  } else {
    H = rdi(); n = rdi(); m = rdi();
    A = rd(H * n * n); B = rd(H * n * m); c = rd(H * n); x0 = rd(n);
    Q = rd(n * n); QN = rd(n * n); R = rd(m * m); lb = rd(m); ub = rd(m);
    // optional tracking payload: x_ref (H*n) then u_ref (H*m)
    {
      Vec tmp((size_t)(H * n));
      size_t got = std::fread(tmp.data(), 8, (size_t)(H * n), f);
      if (got == (size_t)(H * n)) {
        xref = std::move(tmp);
        uref = rd(H * m);
        has_refs = true;
      } else if (got != 0) {
        std::exit(2);
      }
    }
    std::fclose(f);
  }

  Vec u;
  int rc = solve_condensed_qp(H, n, m, A, B, c, x0, Q, QN, R, lb, ub, u,
                              has_refs ? &xref : nullptr,
                              has_refs ? &uref : nullptr);
  if (rc) return rc;
  FILE* fo = std::fopen(fout, "wb");
  if (!fo) return 2;
  std::fwrite(u.data(), 8, (size_t)(H * m), fo);
  std::fclose(fo);
  return 0;
}

static int solve_condensed_qp(int64_t H, int64_t n, int64_t m, const Vec& A,
                              const Vec& B, const Vec& c, const Vec& x0_,
                              const Vec& Q, const Vec& QN, const Vec& R,
                              const Vec& lb, const Vec& ub, Vec& u_out,
                              const Vec* xr, const Vec* ur) {
  // xr (H*n) / ur (H*m): optional tracking references — the stage cost
  // becomes (x-xr)^T W (x-xr) + (u-ur)^T R (u-ur); only the linear term g
  // changes (constant offsets drop out of the argmin).
  const Vec& x0 = x0_;
  const int64_t N = H * m;

  // ---- condense:  x_{t+1} = Phi_t x0 + sum_j S[t][j] u_j + d_t
  // Su[(t)*H + j] is the (n, m) block dx_{t+1}/du_j  (j <= t)
  vector<Vec> Su((size_t)(H * H), Vec((size_t)(n * m), 0.0));
  Vec Phi(n * n), d((size_t)(H * n), 0.0), tmp(n * n), tv(n);
  // t = 0
  for (int64_t i = 0; i < n * m; ++i) Su[0][i] = B[i];
  matvec(&A[0], x0.data(), tv.data(), n, n);
  for (int64_t i = 0; i < n; ++i) d[i] = tv[i] + c[i];
  Vec xlin((size_t)(H * n));  // affine part of the state trajectory
  for (int64_t i = 0; i < n; ++i) xlin[i] = d[i];
  for (int64_t t = 1; t < H; ++t) {
    const double* At = &A[t * n * n];
    // propagate previous blocks
    for (int64_t j = 0; j < t; ++j) {
      matmul(At, Su[(t - 1) * H + j].data(), Su[t * H + j].data(), n, n, m);
    }
    // new block
    for (int64_t i = 0; i < n * m; ++i) Su[t * H + t][i] = B[t * n * m + i];
    // affine
    matvec(At, &xlin[(t - 1) * n], tv.data(), n, n);
    for (int64_t i = 0; i < n; ++i) xlin[t * n + i] = tv[i] + c[t * n + i];
  }

  // ---- condensed QP via the flat sensitivity matrix Sfull (H*n, N):
  //      x = Sfull u + xlin,  H_qp = Sfull^T W Sfull + I_H (x) R,
  //      g = Sfull^T W xlin           (W = blockdiag(Q..Q, QN))
  Vec Hqp((size_t)(N * N), 0.0), g((size_t)N, 0.0);
  Vec Sfull((size_t)(H * n) * N, 0.0);
  for (int64_t t = 0; t < H; ++t)
    for (int64_t j = 0; j <= t; ++j)
      for (int64_t i = 0; i < n; ++i)
        for (int64_t r = 0; r < m; ++r)
          Sfull[(t * n + i) * N + j * m + r] = Su[t * H + j][i * m + r];
  Vec WS((size_t)(H * n) * N, 0.0);
  for (int64_t t = 0; t < H; ++t) {
    const double* W = (t == H - 1) ? QN.data() : Q.data();
    for (int64_t i = 0; i < n; ++i)
      for (int64_t col = 0; col < N; ++col) {
        double s = 0;
        for (int64_t k = 0; k < n; ++k)
          s += W[i * n + k] * Sfull[(t * n + k) * N + col];
        WS[(t * n + i) * N + col] = s;
      }
  }
  for (int64_t r = 0; r < N; ++r)
    for (int64_t col = r; col < N; ++col) {
      double s = 0;
      for (int64_t i = 0; i < H * n; ++i)
        s += Sfull[i * N + r] * WS[i * N + col];
      Hqp[r * N + col] = s;
      Hqp[col * N + r] = s;
    }
  for (int64_t t = 0; t < H; ++t)
    for (int64_t r = 0; r < m; ++r)
      for (int64_t s2 = 0; s2 < m; ++s2)
        Hqp[(t * m + r) * N + t * m + s2] += R[r * m + s2];
  Vec xlin_t = xlin;  // tracking: shift the affine trajectory by x_ref
  if (xr)
    for (int64_t i = 0; i < H * n; ++i) xlin_t[i] -= (*xr)[i];
  for (int64_t col = 0; col < N; ++col) {
    double s = 0;
    for (int64_t t = 0; t < H; ++t) {
      const double* W = (t == H - 1) ? QN.data() : Q.data();
      for (int64_t i = 0; i < n; ++i) {
        double wx = 0;
        for (int64_t k = 0; k < n; ++k) wx += W[i * n + k] * xlin_t[t * n + k];
        s += Sfull[(t * n + i) * N + col] * wx;
      }
    }
    g[col] = s;
  }
  if (ur)  // -R u_ref per stage
    for (int64_t t = 0; t < H; ++t)
      for (int64_t r = 0; r < m; ++r) {
        double s = 0;
        for (int64_t s2 = 0; s2 < m; ++s2)
          s += R[r * m + s2] * (*ur)[t * m + s2];
        g[t * m + r] -= s;
      }

  // ---- primal-dual interior point on  min 1/2 u^T Hqp u + g^T u,
  //      lb <= u_t <= ub  (long-step Mehrotra-free path following)
  Vec u((size_t)N), LB((size_t)N), UB((size_t)N);
  for (int64_t t = 0; t < H; ++t)
    for (int64_t r = 0; r < m; ++r) {
      LB[t * m + r] = lb[r];
      UB[t * m + r] = ub[r];
      u[t * m + r] = 0.5 * (lb[r] + ub[r]);
    }
  Vec zl((size_t)N, 1.0), zu((size_t)N, 1.0);
  for (int iter = 0; iter < 60; ++iter) {
    Vec sl((size_t)N), su((size_t)N), grad((size_t)N);
    matvec(Hqp.data(), u.data(), grad.data(), (int)N, (int)N);
    double mu = 0;
    for (int64_t i = 0; i < N; ++i) {
      grad[i] += g[i];
      // floor the slacks: near convergence an active coordinate's slack can
      // underflow to exactly 0 after a unit step, and 1/sl would poison the
      // next KKT system with inf/NaN
      sl[i] = std::fmax(u[i] - LB[i], 1e-14);
      su[i] = std::fmax(UB[i] - u[i], 1e-14);
      mu += sl[i] * zl[i] + su[i] * zu[i];
    }
    mu /= (2.0 * N);
    if (mu < 1e-13) break;  // converged: complementarity at solver precision
    double sigma = 0.1;
    // KKT: (Hqp + Zl/Sl + Zu/Su) du = -(grad - zl + zu)
    //       + (sigma mu)(1/sl - 1/su)
    Vec M = Hqp, rhs((size_t)N);
    for (int64_t i = 0; i < N; ++i) {
      M[i * N + i] += zl[i] / sl[i] + zu[i] / su[i];
      rhs[i] = -(grad[i] - zl[i] + zu[i]) + sigma * mu * (1.0 / sl[i] - 1.0 / su[i]);
    }
    Vec du = rhs;
    if (!chol_solve(M, du, (int)N)) return 3;
    Vec dzl((size_t)N), dzu((size_t)N);
    for (int64_t i = 0; i < N; ++i) {
      dzl[i] = (sigma * mu - zl[i] * du[i]) / sl[i] - zl[i];
      dzu[i] = (sigma * mu + zu[i] * du[i]) / su[i] - zu[i];
    }
    double ap = 1.0, ad = 1.0;
    for (int64_t i = 0; i < N; ++i) {
      if (du[i] < 0) ap = std::fmin(ap, -0.995 * sl[i] / du[i]);
      if (du[i] > 0) ap = std::fmin(ap, 0.995 * su[i] / du[i]);
      if (dzl[i] < 0) ad = std::fmin(ad, -0.995 * zl[i] / dzl[i]);
      if (dzu[i] < 0) ad = std::fmin(ad, -0.995 * zu[i] / dzu[i]);
    }
    double step_norm = 0;
    for (int64_t i = 0; i < N; ++i) {
      u[i] += ap * du[i];
      zl[i] += ad * dzl[i];
      zu[i] += ad * dzu[i];
      step_norm = std::fmax(step_norm, std::fabs(ap * du[i]));
    }
    if (mu < 1e-14 && step_norm < 1e-12) break;
  }

  u_out = u;
  return 0;
}
