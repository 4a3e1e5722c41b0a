"""Chain diagnostics matching the reference's reporting.

* integrated autocorrelation time — emcee's FFT estimator with the
  c=5 auto-window (the reference calls sampler.get_autocorr_time(),
  bao/desi.py:131-139)
* effective samples = ndim * n_walkers * n_kept / max(tau)
  (bao/desi.py:134-136)
* Gelman-Rubin R-hat over walkers (reference sn/plotting.py:76-87)
* percentile summaries at [15.9, 50, 84.1] (bao/desi.py:143-147)

All numpy (post-processing is host-side; chains are small compared to
the sampling compute).
"""

import numpy as np


def _autocorr_1d(x):
    n = len(x)
    nfft = 1 << (2 * n - 1).bit_length()
    x = x - np.mean(x)
    f = np.fft.fft(x, n=nfft)
    acf = np.fft.ifft(f * np.conjugate(f))[:n].real
    if acf[0] == 0:
        return np.zeros(n)
    return acf / acf[0]


def autocorr_time(samples, c: float = 5.0, tol: float = 50.0, quiet: bool = True):
    """samples: [T, W, D] -> tau[D], emcee's estimator: mean ACF over
    walkers, tau = 2 cumsum(rho) - 1, windowed at the smallest M with
    M >= c * tau(M).

    Raises RuntimeError if the chain is shorter than tol * tau unless
    ``quiet`` (emcee.autocorr.AutocorrError semantics).
    """
    samples = np.asarray(samples)
    t, w, d = samples.shape
    taus = np.empty(d)
    for k in range(d):
        acf = np.mean([_autocorr_1d(samples[:, j, k]) for j in range(w)], axis=0)
        tau_cum = 2.0 * np.cumsum(acf) - 1.0
        window = np.arange(len(tau_cum)) >= c * tau_cum
        m = np.argmin(~window) if window.any() else len(tau_cum) - 1
        taus[k] = tau_cum[m]
    if not quiet and np.any(t < tol * taus):
        raise RuntimeError(
            f"chain too short for reliable tau: T={t} < {tol} * tau={taus}"
        )
    return taus


def effective_samples(samples, taus=None):
    t, w, d = np.asarray(samples).shape
    if taus is None:
        taus = autocorr_time(samples)
    return d * w * t / np.max(taus)


def gelman_rubin(samples):
    """R-hat per dimension, walkers as independent chains
    (reference sn/plotting.py:76-87)."""
    x = np.asarray(samples)  # [T, W, D]
    t = x.shape[0]
    chain_means = x.mean(axis=0)  # [W, D]
    chain_vars = x.var(axis=0, ddof=1)  # [W, D]
    w_var = chain_vars.mean(axis=0)
    b_var = t * chain_means.var(axis=0, ddof=1)
    var_est = (1 - 1 / t) * w_var + b_var / t
    return np.sqrt(var_est / w_var)


def split_gelman_rubin(samples):
    """Split R-hat (Gelman et al. 2013, BDA3 SS11.4): each chain is cut
    in half and the halves treated as separate chains, so within-chain
    non-stationarity (a drifting or stuck chain whose full-length mean
    looks fine) inflates the between-chain variance. The standard HMC
    health diagnostic; the reference's plain R-hat
    (sn/plotting.py:76-87) is kept for reporting parity."""
    x = np.asarray(samples)  # [T, W, D]
    half = x.shape[0] // 2
    if half < 2:
        return gelman_rubin(x)
    return gelman_rubin(
        np.concatenate([x[:half], x[half : 2 * half]], axis=1)
    )


def percentile_summary(flat_samples, names=None):
    """Median +/- (84.1-50)/(50-15.9) percentile errors per dimension
    (bao/desi.py:143-158). Returns dict name -> (median, plus, minus).
    """
    flat = np.asarray(flat_samples)
    p16, p50, p84 = np.percentile(flat, [15.9, 50, 84.1], axis=0)
    names = names or [f"p{i}" for i in range(flat.shape[1])]
    return {
        n: (p50[i], p84[i] - p50[i], p50[i] - p16[i]) for i, n in enumerate(names)
    }


def correlation_matrix(flat_samples):
    """Sample correlation matrix (cosmic_chronometers/cc.py:105-106)."""
    return np.corrcoef(np.asarray(flat_samples), rowvar=False)
