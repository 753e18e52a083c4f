// Bayesian-optimization autotune search: a small Gaussian process with an
// expected-improvement acquisition, hand-rolled (Cholesky on <=32 samples
// needs no Eigen/LBFGS).
//
// Role parity: the reference tunes its knob space with a GP + EI searcher
// (horovod/common/optim/bayesian_optimization.cc:1,
// optim/gaussian_process.cc:1) driven by ParameterManager on the
// coordinator (parameter_manager.cc:528). Here the TcpController owns the
// tuner and distributes winning parameters in every ResponseList, so all
// ranks agree by construction. The search runs in the normalized unit
// cube; the controller maps dimensions onto log2(fusion threshold) and
// log(cycle time).
#pragma once

#include <cstdint>
#include <vector>

namespace hvd {

// Zero-mean GP with an RBF kernel over standardized observations.
class GaussianProcess {
 public:
  explicit GaussianProcess(double length_scale = 0.25,
                           double noise = 1e-4)
      : l_(length_scale), noise_(noise) {}

  // Fit to (X, y); y is standardized internally. Returns false when the
  // Cholesky factorization fails (degenerate kernel matrix).
  bool Fit(const std::vector<std::vector<double>>& xs,
           const std::vector<double>& ys);

  // Posterior mean and variance (of the standardized target) at x.
  void Predict(const std::vector<double>& x, double* mu,
               double* var) const;

  double y_mean() const { return y_mean_; }
  double y_std() const { return y_std_; }

 private:
  double Kernel(const std::vector<double>& a,
                const std::vector<double>& b) const;

  double l_;
  double noise_;
  std::vector<std::vector<double>> xs_;
  std::vector<double> alpha_;       // K^-1 y (standardized)
  std::vector<double> chol_;        // lower-triangular factor, row-major
  double y_mean_ = 0.0;
  double y_std_ = 1.0;
};

// Sequential maximizer over the unit cube [0,1]^dims.
class BayesianTuner {
 public:
  BayesianTuner(int dims, uint64_t seed = 0x5eedu, int pre_samples = 5);

  // Point the caller should evaluate next. Stable until Observe().
  const std::vector<double>& Next() const { return next_; }

  // Record the score achieved at x (normally the point from Next()),
  // then pick the next point: remaining pre-samples first, then the
  // expected-improvement argmax over random candidates.
  void Observe(const std::vector<double>& x, double y);

  // Best observed point so far (the winner to pin).
  std::vector<double> Best() const;

  int n_samples() const { return static_cast<int>(ys_.size()); }

 private:
  double Rand01();  // xorshift; deterministic per seed

  int dims_;
  uint64_t rng_;
  std::vector<std::vector<double>> pre_;  // seeding design
  std::vector<std::vector<double>> xs_;
  std::vector<double> ys_;
  std::vector<double> next_;
};

}  // namespace hvd
