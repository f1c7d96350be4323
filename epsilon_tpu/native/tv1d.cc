// Exact 1-D total-variation prox (fused-lasso signal approximator).
//
// Native equivalent of the reference's only third-party numerical kernel,
// glmgen tf_dp (linked at Makefile:100-101, used by
// src/epsilon/prox/total_variation_1d.cc): direct non-iterative taut-string
// algorithm, O(n) time / O(1) extra space.  Used as the exact host path and
// test oracle; the device hot loop uses the FFT-based ADMM kernel
// (epsilon_tpu/ops/prox/tv1d.py).

#include <cstdint>

extern "C" {

// argmin_x 0.5*||x - y||^2 + lam * sum |x_{i+1} - x_i|
void tv1d_prox(const double* y, double* x, int64_t n, double lam) {
  if (n <= 0) return;
  if (n == 1 || lam <= 0) {
    for (int64_t i = 0; i < n; i++) x[i] = y[i];
    return;
  }

  int64_t k = 0, k0 = 0, kminus = 0, kplus = 0;
  double vmin = y[0] - lam, vmax = y[0] + lam;
  double umin = lam, umax = -lam;

  while (true) {
    if (k == n - 1) {
      if (umin < 0.0) {
        for (int64_t i = k0; i <= kminus; i++) x[i] = vmin;
        k = k0 = kminus = kminus + 1;
        vmin = y[k];
        umin = lam;
        umax = vmin + lam - vmax;
      } else if (umax > 0.0) {
        for (int64_t i = k0; i <= kplus; i++) x[i] = vmax;
        k = k0 = kplus = kplus + 1;
        vmax = y[k];
        umax = -lam;
        umin = vmax - lam - vmin;
      } else {
        double val = vmin + umin / (double)(k - k0 + 1);
        for (int64_t i = k0; i < n; i++) x[i] = val;
        return;
      }
      if (k == n - 1) {
        x[k] = vmin + umin;
        return;
      }
      continue;
    }

    if (y[k + 1] + umin < vmin - lam) {
      // negative jump: the string must bend down at kminus
      for (int64_t i = k0; i <= kminus; i++) x[i] = vmin;
      k = k0 = kminus = kplus = kminus + 1;
      vmin = y[k];
      vmax = y[k] + 2 * lam;
      umin = lam;
      umax = -lam;
    } else if (y[k + 1] + umax > vmax + lam) {
      // positive jump: bend up at kplus
      for (int64_t i = k0; i <= kplus; i++) x[i] = vmax;
      k = k0 = kminus = kplus = kplus + 1;
      vmin = y[k] - 2 * lam;
      vmax = y[k];
      umin = lam;
      umax = -lam;
    } else {
      // extend the current segment
      k += 1;
      umin += y[k] - vmin;
      umax += y[k] - vmax;
      if (umin >= lam) {
        vmin += (umin - lam) / (double)(k - k0 + 1);
        umin = lam;
        kminus = k;
      }
      if (umax <= -lam) {
        vmax += (umax + lam) / (double)(k - k0 + 1);
        umax = -lam;
        kplus = k;
      }
    }
  }
}

// Batched variant (rows of a C-contiguous (batch, n) matrix).
void tv1d_prox_batch(const double* Y, double* X, int64_t batch, int64_t n,
                     const double* lams) {
  for (int64_t b = 0; b < batch; b++) {
    tv1d_prox(Y + b * n, X + b * n, n, lams[b]);
  }
}

// Weighted TV via the same taut string with per-edge weights is not part of
// the reference surface; omitted.

}  // extern "C"
