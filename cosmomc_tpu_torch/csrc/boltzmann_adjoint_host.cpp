// A plain C interface to csrc/boltzmann_adjoint.cuh on the host, in float64,
// so that K1's hand-written adjoint can be held against autograd of the
// plain version without a card (tests/test_torch_grad_extended.py builds it
// with the host C++ compiler: g++ -O2 -shared -fPIC -std=c++17). One pair of
// entry points per instantiation of (massive_nu, de_perts):
//   k1_step_<v>: one RK4 step of _evolve_plain from y over the rows qa, qm,
//     qb (the held ICs before the lane's release) and the 7 source planes at
//     its end;
//   k1_step_vjp_<v>: the vjp of that step for the cotangents ynb of the new
//     state and g of the planes: yb (the state's), qab, qmb, qbb (the
//     rows'), and rnu_b, isob[3] added to.
// iso: b, omega, R_c; nuc: the normalized node weights, then d ln f0/d ln q.
#include "boltzmann_adjoint.cuh"

namespace {

template <bool NU, bool DE>
void step_planes(const double* y, const double* qa, const double* qm, const double* qb,
                 double k, double rsa_ktau, double rnu, const double* iso, const double* nuc,
                 double* yn, double* planes) {
  namespace A = k1adj;
  const A::Iso<double> is = {iso[0], iso[1], iso[2]};
  A::step<double, NU, DE>(y, qa, qm, qb, k, rsa_ktau, rnu, is, nuc, yn);
  double dy[A::Layout<NU, DE>::NVX];
  A::Aux<double> a;
  A::rhs<double, NU, DE>(yn, qb, k, rsa_ktau, nuc, dy, &a);
  A::sources<double, NU>(yn, dy, a, qb, k, planes);
}

template <bool NU, bool DE>
void step_vjp(const double* y, const double* qa, const double* qm, const double* qb,
              double k, double rsa_ktau, double rnu, const double* iso, const double* nuc,
              const double* ynb, const double* g, double* yb, double* qab, double* qmb,
              double* qbb, double* rnu_b, double* isob) {
  namespace A = k1adj;
  const A::Iso<double> is = {iso[0], iso[1], iso[2]};
  double yn[A::Layout<NU, DE>::NVX];
  A::step<double, NU, DE>(y, qa, qm, qb, k, rsa_ktau, rnu, is, nuc, yn);
  A::step_vjp<double, NU, DE>(y, yn, qa, qm, qb, k, rsa_ktau, rnu, is, nuc, ynb, g, yb, qab,
                              qmb, qbb, rnu_b, isob);
}

}  // namespace

#define K1_HOST_ENTRIES(V, NU, DE)                                                          \
  extern "C" void k1_step_##V(const double* y, const double* qa, const double* qm,         \
                              const double* qb, double k, double rsa_ktau, double rnu,     \
                              const double* iso, const double* nuc, double* yn,            \
                              double* planes) {                                            \
    step_planes<NU, DE>(y, qa, qm, qb, k, rsa_ktau, rnu, iso, nuc, yn, planes);            \
  }                                                                                        \
  extern "C" void k1_step_vjp_##V(const double* y, const double* qa, const double* qm,     \
                                  const double* qb, double k, double rsa_ktau, double rnu, \
                                  const double* iso, const double* nuc, const double* ynb, \
                                  const double* g, double* yb, double* qab, double* qmb,   \
                                  double* qbb, double* rnu_b, double* isob) {              \
    step_vjp<NU, DE>(y, qa, qm, qb, k, rsa_ktau, rnu, iso, nuc, ynb, g, yb, qab, qmb, qbb, \
                     rnu_b, isob);                                                         \
  }
K1_HOST_ENTRIES(base, false, false)
K1_HOST_ENTRIES(nu, true, false)
K1_HOST_ENTRIES(de, false, true)
K1_HOST_ENTRIES(nu_de, true, true)
