"""Deterministic data simulation matching the reference R test suite.

The reference pins all golden values to data generated by a hand-rolled linear
congruential generator plus qnorm (R-package/tests/testthat/
test_GPModel_gaussian_process.R:35-41), making them reproducible in any language.
This module is the Python/numpy equivalent and is the acceptance oracle for the
whole framework.
"""

import numpy as np
from scipy.stats import norm as _norm


def sim_rand_unif(n, init_c=0.1, mod_lcg=2 ** 32, mult=22695477, inc=1):
    """LCG uniforms, bit-identical to the R helper `sim_rand_unif`.

    x_1 = floor(init_c * mod); x_{i+1} = (mult * x_i + inc) mod mod.
    Different reference test files use different LCG constants:
      * gaussian_process / GPBoost_algorithm: mod 2^32, mult 22695477, inc 1
      * grouped_random_effects:               mod 134456, mult 8121, inc 28411
    IMPORTANT: computed in float64 like R does — for mod 2^32 the product
    overflows the 53-bit mantissa and R's rounded result is part of the golden
    data definition; exact integer arithmetic would NOT reproduce it.
    """
    sim = np.empty(n, dtype=np.float64)
    state = float(np.floor(init_c * mod_lcg))
    sim[0] = state
    for i in range(1, n):
        state = (float(mult) * state + float(inc)) % float(mod_lcg)
        sim[i] = state
    return sim / mod_lcg


def qnorm(p):
    """Standard normal quantile (R qnorm); scipy's ppf matches AS241 precision."""
    return _norm.ppf(p)


def r_matrix(values, ncol):
    """Reshape a flat vector column-major like R's matrix(x, ncol=k)."""
    values = np.asarray(values)
    return values.reshape(ncol, -1).T
