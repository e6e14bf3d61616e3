// The measure predicate shared by every kernel of the port (K1-K5).
//
// `qualify(f, r, s, measure, p, q)` is the JAX package's exact int32
// algebra (src/repro/core/measures.py::device_qualify): p/q is the
// threshold as a rational in lowest terms, the cosine division form uses
// C `/` on non-negative operands (= floor division), and f > 0 is
// required. Measure.validate bounds every intermediate below 2^31 before
// any launch, so nothing here overflows.
#pragma once

enum Measure { kJaccard = 0, kCosine = 1, kDice = 2, kOverlap = 3 };

static __device__ __forceinline__ bool qualify(int f, int r, int s,
                                               int measure, int p, int q) {
  if (f <= 0) return false;
  switch (measure) {
    case kJaccard:
      return f * (p + q) >= p * (r + s);
    case kCosine:
      return f * f >= (p * p * (r * s) + (q * q - 1)) / (q * q);
    case kDice:
      return f * (2 * q) >= p * (r + s);
    default:
      return f * q >= p * min(r, s);
  }
}
