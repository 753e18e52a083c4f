#include "bayes.h"

#include <cmath>

namespace hvd {

namespace {

// standard normal pdf / cdf for expected improvement
double NormPdf(double z) {
  return 0.3989422804014327 * std::exp(-0.5 * z * z);
}

double NormCdf(double z) { return 0.5 * std::erfc(-z * 0.7071067811865476); }

}  // namespace

double GaussianProcess::Kernel(const std::vector<double>& a,
                               const std::vector<double>& b) const {
  double d2 = 0.0;
  for (size_t i = 0; i < a.size(); ++i) {
    double d = a[i] - b[i];
    d2 += d * d;
  }
  return std::exp(-0.5 * d2 / (l_ * l_));
}

bool GaussianProcess::Fit(const std::vector<std::vector<double>>& xs,
                          const std::vector<double>& ys) {
  const size_t n = xs.size();
  xs_ = xs;

  y_mean_ = 0.0;
  for (double y : ys) y_mean_ += y;
  y_mean_ /= n;
  double var = 0.0;
  for (double y : ys) var += (y - y_mean_) * (y - y_mean_);
  y_std_ = std::sqrt(var / n);
  if (y_std_ < 1e-12) y_std_ = 1.0;  // flat scores: GP sees all-zeros

  std::vector<double> yn(n);
  for (size_t i = 0; i < n; ++i) yn[i] = (ys[i] - y_mean_) / y_std_;

  // K + noise I, then in-place Cholesky (row-major lower triangle)
  chol_.assign(n * n, 0.0);
  for (size_t i = 0; i < n; ++i) {
    for (size_t j = 0; j <= i; ++j) {
      chol_[i * n + j] = Kernel(xs_[i], xs_[j]) + (i == j ? noise_ : 0.0);
    }
  }
  for (size_t i = 0; i < n; ++i) {
    for (size_t j = 0; j <= i; ++j) {
      double s = chol_[i * n + j];
      for (size_t k = 0; k < j; ++k) {
        s -= chol_[i * n + k] * chol_[j * n + k];
      }
      if (i == j) {
        if (s <= 0.0) return false;
        chol_[i * n + i] = std::sqrt(s);
      } else {
        chol_[i * n + j] = s / chol_[j * n + j];
      }
    }
  }

  // alpha = K^-1 y via L L^T: forward then backward substitution
  alpha_.assign(n, 0.0);
  for (size_t i = 0; i < n; ++i) {
    double s = yn[i];
    for (size_t k = 0; k < i; ++k) s -= chol_[i * n + k] * alpha_[k];
    alpha_[i] = s / chol_[i * n + i];
  }
  for (size_t ii = n; ii-- > 0;) {
    double s = alpha_[ii];
    for (size_t k = ii + 1; k < n; ++k) s -= chol_[k * n + ii] * alpha_[k];
    alpha_[ii] = s / chol_[ii * n + ii];
  }
  return true;
}

void GaussianProcess::Predict(const std::vector<double>& x, double* mu,
                              double* var) const {
  const size_t n = xs_.size();
  std::vector<double> kx(n);
  for (size_t i = 0; i < n; ++i) kx[i] = Kernel(x, xs_[i]);

  double m = 0.0;
  for (size_t i = 0; i < n; ++i) m += kx[i] * alpha_[i];
  *mu = m;

  // v = L^-1 kx; var = k(x,x) - v.v
  std::vector<double> v(n);
  for (size_t i = 0; i < n; ++i) {
    double s = kx[i];
    for (size_t k = 0; k < i; ++k) s -= chol_[i * n + k] * v[k];
    v[i] = s / chol_[i * n + i];
  }
  double vv = 0.0;
  for (size_t i = 0; i < n; ++i) vv += v[i] * v[i];
  double out = 1.0 + noise_ - vv;
  *var = out > 1e-12 ? out : 1e-12;
}

BayesianTuner::BayesianTuner(int dims, uint64_t seed, int pre_samples)
    : dims_(dims), rng_(seed ? seed : 1) {
  // seeding design: center + scrambled corners/edges keeps the first GP
  // fit spread across the cube (a Latin square would need bookkeeping
  // for arbitrary dims; for the 2-3 knobs tuned here this is equivalent)
  pre_.push_back(std::vector<double>(dims_, 0.5));
  for (int s = 1; s < pre_samples; ++s) {
    std::vector<double> p(dims_);
    for (int d = 0; d < dims_; ++d) {
      int bit = (s >> (d % 3)) & 1;
      p[d] = bit ? 0.85 : 0.15;
    }
    // nudge so repeated corners never coincide (degenerate kernel rows)
    p[s % dims_] += 0.02 * s * ((s & 1) ? 1 : -1);
    if (p[s % dims_] < 0.0) p[s % dims_] = 0.0;
    if (p[s % dims_] > 1.0) p[s % dims_] = 1.0;
    pre_.push_back(std::move(p));
  }
  next_ = pre_[0];
}

double BayesianTuner::Rand01() {
  // xorshift64*: deterministic, no <random> state-size baggage
  rng_ ^= rng_ >> 12;
  rng_ ^= rng_ << 25;
  rng_ ^= rng_ >> 27;
  return double((rng_ * 2685821657736338717ull) >> 11) /
         9007199254740992.0;
}

void BayesianTuner::Observe(const std::vector<double>& x, double y) {
  xs_.push_back(x);
  ys_.push_back(y);

  const size_t n = ys_.size();
  if (n < pre_.size()) {
    next_ = pre_[n];
    return;
  }

  GaussianProcess gp;
  if (!gp.Fit(xs_, ys_)) {
    // degenerate fit: fall back to a random probe
    next_.assign(dims_, 0.0);
    for (int d = 0; d < dims_; ++d) next_[d] = Rand01();
    return;
  }

  double best_y = ys_[0];
  for (double v : ys_) best_y = v > best_y ? v : best_y;
  double best_std = (best_y - gp.y_mean()) / gp.y_std();

  // EI argmax over random candidates (the reference polishes with LBFGS;
  // 512 draws over a 2-3D unit cube lands within the kernel length
  // scale of the optimum, which is all the noisy objective supports)
  const double xi = 0.01;
  double best_ei = -1.0;
  std::vector<double> cand(dims_), best_cand(dims_, 0.5);
  for (int t = 0; t < 512; ++t) {
    for (int d = 0; d < dims_; ++d) cand[d] = Rand01();
    double mu, var;
    gp.Predict(cand, &mu, &var);
    double sigma = std::sqrt(var);
    double z = (mu - best_std - xi) / sigma;
    double ei = (mu - best_std - xi) * NormCdf(z) + sigma * NormPdf(z);
    if (ei > best_ei) {
      best_ei = ei;
      best_cand = cand;
    }
  }
  next_ = best_cand;
}

std::vector<double> BayesianTuner::Best() const {
  size_t bi = 0;
  for (size_t i = 1; i < ys_.size(); ++i) {
    if (ys_[i] > ys_[bi]) bi = i;
  }
  return xs_.empty() ? std::vector<double>(dims_, 0.5) : xs_[bi];
}

}  // namespace hvd
