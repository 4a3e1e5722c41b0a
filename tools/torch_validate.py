#!/usr/bin/env python3
"""Posterior-parity validation sweep of the port (the port of
``tools/validate.py``), on the card.

    python3 tools/torch_validate.py [--out build/VALIDATION_torch.md]
        [--quick] [--only SUBSTRING] [--device cuda]

Runs every case of ``CASES`` (a copy of ``tools/validate.py``'s table:
preset, model, options, the published medians and widths of BASELINE.md,
the published chi^2) end to end through the port's fast path
(``get_preset(fast=True)``: one fused-kernel launch a log-prob call) and
the ensemble sampler with the preset's moves, and compares the posterior
medians with the published ones: z = |median - published| / sigma
published, the 0.1-sigma parity target of BASELINE.json. Writes a
markdown table and a JSON sidecar (``--out`` + ``.results.json``).
``--quick`` caps the chains at 128 walkers x 1200 steps; the full sweep
floors them at 512 x 3000 (x ``steps_mult``), hours on one card.
``VALIDATION.md`` belongs to the JAX package and is not written.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (preset, model, kwargs, published{param: (median, sigma)}, chi2_pub[, extra])
# extra (optional dict):
#   steps_mult — multiply the step cap (outlier configs get 4x chains so
#                median noise is << the 0.1-sigma target)
#   alt       — {"label", "target": {param: median}}: a second, exactly
#               reproducible target (e.g. the current-code MAP) when the
#               published row predates the current reference code
CASES = [
    ("bao.desi", "lcdm", {},
     {"h": (0.690, 0.005), "Om": (0.298, 0.009)}, 10.27),
    ("bao.desi", "wzcdm", {},
     {"h": (0.670, 0.016), "Om": (0.308, 0.012), "w0": (-0.832, 0.12)}, 8.44),
    ("bao.desi", "wcdm", {},
     {"h": (0.678, 0.012), "Om": (0.297, 0.009), "w0": (-0.915, 0.077)}, 9.12),
    ("sn.union3", "wcdm", {},
     {"dM": (-0.0579, 0.0868), "Om": (0.2523, 0.0976), "w0": (-0.7472, 0.168)},
     None),
    ("cc.cc", "wcdm", {},
     {"H0": (67.4, 4.4), "Om": (0.315, 0.042), "w0": (-1.054, 0.229),
      "f_cc": (0.71, 0.09)}, 29.29),
    ("bao.sdss", "lcdm", {},
     {"h": (0.688, 0.007), "Om": (0.294, 0.016)}, 11.81),
    ("sn.union3", "lcdm", {},
     {"dM": (-0.070, 0.086), "Om": (0.357, 0.027)}, 24.0),
    ("cmb.cmb", "lcdm", {"compression": "chen"},
     {"H0": (67.40, 0.61), "Om": (0.3167, 0.0085), "Obh2": (0.02236, 0.00015)},
     None),
    ("cmb.cmb", "lcdm", {"compression": "desi"},
     {"H0": (67.50, 0.59), "Om": (0.3119, 0.0081), "Obh2": (0.02223, 0.00014)},
     None),
    ("cmb.cmb", "lcdm", {"compression": "act"},
     {"H0": (67.23, 0.51), "Om": (0.3170, 0.0073)}, None),
    ("cmb.cmb", "lcdm", {"compression": "union3"},
     {"H0": (67.39, 0.59), "Om": (0.3148, 0.0083)}, None),
    ("cc.cc", "lcdm", {},
     {"H0": (67.1, 3.8), "Om": (0.317, 0.039), "f_cc": (0.70, 0.10)}, 30.39),
    ("bao.desi_omh2", "lcdm", {},
     {"h": (0.693, 0.010), "Om": (0.298, 0.009), "rd": (146.48, 1.33)}, 10.27),
    ("bao.desi_bbn", "lcdm", {},
     {"H0": (68.45, 0.44), "Obh2": (0.02190, 0.00024), "Om": (0.2976, 0.0086)},
     10.29),
    ("bao.desi_bbn_theta_star", "lcdm", {},
     {"rd": (148.33, 0.79), "H0": (68.45, 0.65), "Om": (0.2974, 0.009)}, 10.29),
    ("bao.desi_omh2_theta_star", "lcdm", {},
     {"H0": (69.34, 1.02), "Om": (0.297, 0.009), "rd": (146.43, 1.33)}, 10.28),
    ("bao.desi_cc", "lcdm", {},
     {"f_cc": (0.70, 0.10), "H0": (69.1, 2.4), "rd": (146.9, 5.1),
      "Om": (0.299, 0.009)}, 40.55),
    ("bao.desi_union3", "lcdm", {},
     {"dM": (-0.119, 0.089), "H0": (68.69, 0.47), "Om": (0.304, 0.008)}, 38.82),
    ("bao.desi_union3", "w0wacdm", {},
     {"dM": (-0.166, 0.091), "H0": (66.23, 0.92), "Om": (0.330, 0.017),
      "w0": (-0.700, 0.114), "wa": (-0.996, 0.568)}, 28.79),
    ("bao.desi_union3_cc", "lcdm", {},
     {"f_cc": (0.70, 0.10), "dM": (-0.118, 0.09), "H0": (68.7, 2.3),
      "rd": (147.0, 5.0), "Om": (0.304, 0.008)}, 69.1),
    ("bao.desi_union3_omh2", "lcdm", {},
     {"rd": (147.32, 1.27), "H0": (68.59, 0.98), "Om": (0.304, 0.008)}, 38.8),
    # (published r_d = 146.89 there is a derived quantity — r_drag
    # formula — not a sampled parameter)
    ("bao.desi_union3_bbn", "lcdm", {},
     {"H0": (68.79, 0.60), "Obh2": (0.02218, 0.00055), "dM": (-0.116, 0.09)},
     38.8),
    ("bao.desi_cmb", "lcdm", {"compression": "desi"},
     {"rd": (148.41, 0.51), "H0": (68.01, 0.43), "Om": (0.3051, 0.006),
      "Obh2": (0.02231, 0.0002)}, 11.76,
     {"steps_mult": 4,
      # The published row predates the current reference code (see the
      # Attribution section emitted below); the exactly reproducible
      # target is the current-code MAP, computed by scipy minimisation
      # of the f64 likelihood (chi2_min = 11.8495).
      "alt": {"label": "current-code MAP",
              "target": {"rd": 148.4473, "H0": 67.9798, "Om": 0.30529,
                         "Obh2": 0.0223128}}}),
    ("sn.union3_cmb", "lcdm", {},
     {"H0": (67.11, 0.57), "Om": (0.319, 0.008), "dM": (-0.167, 0.09)}, 26.2),
    ("cc.cc_union3", "lcdm", {},
     {"f_cc": (0.70, 0.1), "dM": (-0.202, 0.09), "H0": (65.9, 2.6),
      "Om": (0.349, 0.025)}, 54.25),
    ("qsr.desi", "lcdm", {},
     {"dM_qsr": (-0.197, 0.087), "s": (0.408, 0.07), "rd": (144.86, 1.05),
      "Om": (0.299, 0.009)}, 29.93, {"steps_mult": 4}),
    ("qsr.union3", "lcdm", {},
     {"dM_qsr": (-0.099, 0.09), "s": (0.382, 0.07), "dM": (-0.068, 0.09),
      "Om": (0.370, 0.028)}, 44.00),
    ("fs8.fs8", "lcdm", {},
     {"Om": (0.268, 0.020), "sigma8": (0.789, 0.015), "f_err": (0.78, 0.07)},
     62.73, {"steps_mult": 4}),
    # --- round-2 extensions: second three-probe joint + CC+CMB +
    #     model-family variants of every validatable config -------------
    # bao/desi_cmb_union3.py:251-367 (desi compression, seed 42). The
    # published chi2 values ARE reproducible by the current reference
    # code (unlike bao.desi_cmb): the current-code MAP equals the
    # published medians to their rounding — chi2_min 39.3965 / 36.0703 /
    # 28.8309 vs published 39.40 / 36.07 / 28.85 (scipy Nelder-Mead on
    # the f64 likelihood, which matches the reference's own numpy
    # pipeline bit-for-bit at those points).
    ("bao.desi_cmb_union3", "lcdm", {},
     {"rd": (148.6, 0.5), "H0": (67.8, 0.4), "Om": (0.308, 0.006),
      "Obh2": (0.02228, 0.000125), "dM": (-0.147, 0.0875)}, 39.40),
    ("bao.desi_cmb_union3", "wzcdm", {},
     {"rd": (148.5, 0.5), "H0": (66.5, 0.8), "Om": (0.318, 0.008),
      "Obh2": (0.02235, 0.00013), "w0": (-0.900, 0.0535),
      "dM": (-0.178, 0.0885)}, 36.07),
    ("bao.desi_cmb_union3", "w0wacdm", {},
     {"rd": (147.9, 0.5), "H0": (65.9, 0.8), "Om": (0.328, 0.009),
      "Obh2": (0.02221, 0.00014), "w0": (-0.703, 0.0895),
      "wa": (-0.933, 0.307), "dM": (-0.180, 0.088)}, 28.85),
    # cosmic_chronometers/cc_cmb.py:170-192 (LCDM only; published
    # logL -130.56 matches cosmax's f64 log_prob at the medians)
    ("cc.cc_cmb", "lcdm", {},
     {"H0": (67.39, 0.595), "Om": (0.3168, 0.0082),
      "Obh2": (0.02236, 0.00014), "f_cc": (0.69, 0.085)}, 31.31),
    # bao/desi.py:241-275 SDSS compilation model variants. The published
    # medians sit 0.13-0.19 sigma from the *exact* posterior medians of
    # their own documented likelihood (which reproduces the published
    # chi2 at the published medians to <= 0.05); the reproducible target
    # is the brute-force grid-integrated median (220^3 f64 marginals
    # over the reference prior box) — see the Attribution section.
    ("bao.sdss", "wcdm", {},
     {"h": (0.663, 0.0165), "Om": (0.283, 0.0205), "w0": (-0.793, 0.130)},
     9.81,
     {"alt": {"label": "exact grid median",
              "target": {"h": 0.6645, "Om": 0.2831, "w0": -0.8147}}}),
    ("bao.sdss", "wzcdm", {},
     {"h": (0.659, 0.020), "Om": (0.305, 0.0175), "w0": (-0.737, 0.172)},
     10.04,
     {"alt": {"label": "exact grid median",
              "target": {"h": 0.6621, "Om": 0.3028, "w0": -0.7729}}}),
    # sn/union3.py:216-228 wzCDM (the published w0waCDM row used a wider
    # wa prior than the registry's reference-standard (-3, 2) — its
    # wa median -3.94 lies outside that box — so it is not comparable)
    ("sn.union3", "wzcdm", {},
     {"dM": (-0.0540, 0.0872), "Om": (0.2957, 0.053),
      "w0": (-0.7510, 0.156)}, 21.7),
    # cosmic_chronometers/cc.py:205-217 wzCDM
    ("cc.cc", "wzcdm", {},
     {"H0": (68.2, 5.5), "Om": (0.308, 0.050), "w0": (-1.137, 0.412),
      "f_cc": (0.71, 0.09)}, 29.39),
    # quasars/qsr_desi.py:246-267 wCDM / wzCDM
    ("qsr.desi", "wcdm", {},
     {"dM_qsr": (-0.159, 0.0955), "s": (0.406, 0.067),
      "rd": (142.307, 2.46), "Om": (0.298, 0.009), "w0": (-0.911, 0.0785)},
     28.89, {"steps_mult": 4}),
    ("qsr.desi", "wzcdm", {},
     {"dM_qsr": (-0.135, 0.0995), "s": (0.406, 0.068),
      "rd": (140.537, 3.25), "Om": (0.310, 0.012), "w0": (-0.827, 0.1255)},
     28.21, {"steps_mult": 4}),
    # fs8/fs8.py:233-253 wCDM / wzCDM
    ("fs8.fs8", "wcdm", {},
     {"Om": (0.285, 0.0225), "sigma8": (0.860, 0.0635),
      "w0": (-0.799, 0.1415), "f_err": (0.78, 0.065)}, 61.64,
     {"steps_mult": 4}),
    ("fs8.fs8", "wzcdm", {},
     {"Om": (0.300, 0.0325), "sigma8": (0.830, 0.0385),
      "w0": (-0.711, 0.2285), "f_err": (0.78, 0.065)}, 61.26,
     {"steps_mult": 4}),
    # cosmic_chronometers/cc.py:180-187 "Without f" (f fixed to 1)
    ("cc.cc_plain", "lcdm", {},
     {"H0": (66.8, 5.3), "Om": (0.321, 0.052)}, 14.87),
    # bao/desi_union3.py:251-279 wCDM / wzCDM
    ("bao.desi_union3", "wcdm", {},
     {"dM": (-0.156, 0.0885), "H0": (67.12, 0.735), "Om": (0.298, 0.009),
      "w0": (-0.866, 0.0505)}, 32.17),
    ("bao.desi_union3", "wzcdm", {},
     {"dM": (-0.163, 0.0895), "H0": (66.66, 0.81), "Om": (0.310, 0.0085),
      "w0": (-0.803, 0.0655)}, 30.37),
    # --- round-4 extensions (VERDICT r3 item 1): every remaining
    #     published model-family row on intact-covariance configs -------
    # bao/desi_cc.py:247-280 wCDM / wzCDM / w0waCDM
    ("bao.desi_cc", "wcdm", {},
     {"f_cc": (0.70, 0.09), "H0": (67.9, 2.65), "rd": (147.1, 5.0),
      "Om": (0.298, 0.009), "w0": (-0.922, 0.0765)}, 39.31),
    ("bao.desi_cc", "wzcdm", {},
     {"f_cc": (0.71, 0.09), "H0": (67.2, 2.8), "rd": (147.2, 4.95),
      "Om": (0.307, 0.011), "w0": (-0.854, 0.122)}, 38.74),
    ("bao.desi_cc", "w0wacdm", {},
     {"f_cc": (0.72, 0.09), "H0": (65.2, 3.4), "rd": (147.2, 5.05),
      "Om": (0.343, 0.0385), "w0": (-0.593, 0.306), "wa": (-1.309, 1.15)},
     37.03),
    # bao/desi_bbn.py:243-272 wCDM / wzCDM
    ("bao.desi_bbn", "wcdm", {},
     {"H0": (66.25, 2.165), "Obh2": (0.02190, 0.00025), "Om": (0.2970, 0.0089),
      "w0": (-0.918, 0.0775)}, 9.05),
    ("bao.desi_bbn", "wzcdm", {},
     {"H0": (65.65, 2.115), "Obh2": (0.02190, 0.00025), "Om": (0.3076, 0.0117),
      "w0": (-0.834, 0.124)}, 8.42),
    # bao/desi_omh2.py:314-339 wCDM / wzCDM
    ("bao.desi_omh2", "wcdm", {},
     {"h": (0.694, 0.011), "Om": (0.297, 0.009), "w0": (-0.914, 0.078),
      "rd": (144.03, 2.805)}, 9.16),
    ("bao.desi_omh2", "wzcdm", {},
     {"h": (0.681, 0.013), "Om": (0.308, 0.012), "w0": (-0.832, 0.1245),
      "rd": (144.70, 1.94)}, 8.44),
    # bao/desi_bbn_theta_star.py:300-323 wCDM / wzCDM
    ("bao.desi_bbn_theta_star", "wcdm", {},
     {"rd": (148.34, 0.795), "H0": (67.29, 1.21), "Om": (0.2968, 0.00875),
      "Obh2": (0.02218, 0.000545), "w0": (-0.916, 0.076)}, 10.03),
    ("bao.desi_bbn_theta_star", "wzcdm", {},
     {"rd": (148.17, 0.81), "H0": (66.53, 1.555), "Om": (0.3076, 0.0117),
      "Obh2": (0.02218, 0.00054), "w0": (-0.832, 0.124)}, 8.44),
    # bao/desi_omh2_theta_star.py:298-322 wCDM / wzCDM. The published
    # rows (all three families) were produced with the Hu-Sugiyama z*
    # variant — their quoted z* equals z_star_HU(wb, wm) at the quoted
    # medians to 2 decimals, while the current reference code's Aizpuru
    # z* gives theta* chi2 of 28-34 at those same medians (see the
    # Attribution section) — so the sweep validates them against the
    # configuration that produced them (z_star="hu").
    ("bao.desi_omh2_theta_star", "wcdm", {"z_star": "hu"},
     {"H0": (69.42, 1.06), "Om": (0.297, 0.009), "Obh2": (0.02582, 0.00265),
      "w0": (-0.916, 0.077), "rd": (143.98, 2.775)}, 9.71),
    ("bao.desi_omh2_theta_star", "wzcdm", {"z_star": "hu"},
     {"H0": (68.18, 1.305), "Om": (0.308, 0.012), "Obh2": (0.02506, 0.00162),
      "w0": (-0.831, 0.1225), "rd": (144.62, 1.935)}, 8.47),
    # bao/desi_union3_cc.py:214-250 wCDM / wzCDM / w0waCDM
    ("bao.desi_union3_cc", "wcdm", {},
     {"f_cc": (0.70, 0.09), "dM": (-0.158, 0.1165), "H0": (67.1, 2.4),
      "rd": (147.3, 5.0), "Om": (0.298, 0.009), "w0": (-0.870, 0.051)}, 62.6),
    ("bao.desi_union3_cc", "wzcdm", {},
     {"f_cc": (0.71, 0.09), "dM": (-0.165, 0.118), "H0": (66.7, 2.4),
      "rd": (147.2, 5.0), "Om": (0.310, 0.0085), "w0": (-0.811, 0.0655)},
     60.7),
    ("bao.desi_union3_cc", "w0wacdm", {},
     {"f_cc": (0.71, 0.09), "dM": (-0.167, 0.1165), "H0": (66.3, 2.4),
      "rd": (147.1, 5.0), "Om": (0.329, 0.017), "w0": (-0.722, 0.1095),
      "wa": (-0.901, 0.5575)}, 59.1),
    # bao/desi_union3_omh2.py:270-298 wCDM / wzCDM / w0waCDM (dM sampled
    # but not published — compared params are the published four/five)
    ("bao.desi_union3_omh2", "wcdm", {},
     {"rd": (142.55, 2.465), "H0": (69.31, 1.09), "Om": (0.298, 0.009),
      "w0": (-0.866, 0.051)}, 32.2),
    ("bao.desi_union3_omh2", "wzcdm", {},
     {"rd": (144.33, 1.655), "H0": (67.95, 0.985), "Om": (0.310, 0.009),
      "w0": (-0.803, 0.0665)}, 30.4),
    ("bao.desi_union3_omh2", "w0wacdm", {},
     {"rd": (148.08, 2.725), "H0": (65.78, 1.69), "Om": (0.331, 0.017),
      "w0": (-0.698, 0.112), "wa": (-1.006, 0.558)}, 28.8),
    # bao/desi_union3_bbn.py:279-303 wCDM / wzCDM
    ("bao.desi_union3_bbn", "wcdm", {},
     {"dM": (-0.223, 0.1005), "H0": (65.12, 1.565), "Om": (0.298, 0.009),
      "Obh2": (0.02218, 0.000545), "w0": (-0.868, 0.0505)}, 32.2),
    ("bao.desi_union3_bbn", "wzcdm", {},
     {"dM": (-0.205, 0.0945), "H0": (65.40, 1.27), "Om": (0.310, 0.009),
      "Obh2": (0.02219, 0.000545), "w0": (-0.803, 0.066)}, 30.4),
    # bao/desi_cmb.py:249-322 wCDM / wzCDM / w0waCDM on the desi
    # compression and all four families on chen
    # All desi-compression families inherit the bao.desi_cmb lcdm
    # version drift (see the Attribution section): the current
    # reference code gives chi2 11.72/12.20/8.04 at the published
    # medians vs published 11.51/11.77/6.81, and its own MAP rd is
    # offset from the published rd by the z*-formula change. The
    # exactly reproducible target is the current-code MAP
    # (scipy Nelder-Mead on the f64 parity likelihood).
    ("bao.desi_cmb", "wcdm", {"compression": "desi"},
     {"rd": (148.36, 0.515), "H0": (68.50, 0.98), "Om": (0.3016, 0.00845),
      "Obh2": (0.02228, 0.00014), "w0": (-1.023, 0.0395)}, 11.51,
     {"steps_mult": 4,
      "alt": {"label": "current-code MAP",
              "target": {"rd": 148.38854, "H0": 68.49329, "Om": 0.30152,
                         "Obh2": 0.02228, "w0": -1.02293}}}),
    ("bao.desi_cmb", "wzcdm", {"compression": "desi"},
     {"rd": (148.42, 0.515), "H0": (68.03, 1.385), "Om": (0.3050, 0.01205),
      "Obh2": (0.02231, 0.00014), "w0": (-1.002, 0.090)}, 11.77,
     {"steps_mult": 4,
      "alt": {"label": "current-code MAP",
              "target": {"rd": 148.44343, "H0": 68.04094, "Om": 0.30478,
                         "Obh2": 0.02231, "w0": -1.00388}}}),
    ("bao.desi_cmb", "w0wacdm", {"compression": "desi"},
     {"rd": (147.71, 0.56), "H0": (63.97, 2.095), "Om": (0.3482, 0.02385),
      "Obh2": (0.02219, 0.00014), "w0": (-0.50, 0.245), "wa": (-1.49, 0.71)},
     6.81, {"steps_mult": 4,
            "alt": {"label": "current-code MAP",
                    "target": {"rd": 147.76325, "H0": 64.02317,
                               "Om": 0.34735, "Obh2": 0.02220,
                               "w0": -0.50933, "wa": -1.43741}}}),
    ("bao.desi_cmb", "lcdm", {"compression": "chen"},
     {"rd": (148.00, 0.52), "H0": (68.07, 0.445), "Om": (0.3076, 0.0059),
      "Obh2": (0.02246, 0.00013)}, 12.83, {"steps_mult": 4}),
    ("bao.desi_cmb", "wcdm", {"compression": "chen"},
     {"rd": (147.95, 0.525), "H0": (68.83, 1.00), "Om": (0.3021, 0.00865),
      "Obh2": (0.02241, 0.00014), "w0": (-1.036, 0.041)}, 12.17,
     {"steps_mult": 4}),
    ("bao.desi_cmb", "wzcdm", {"compression": "chen"},
     {"rd": (148.00, 0.525), "H0": (68.45, 1.42), "Om": (0.3045, 0.01225),
      "Obh2": (0.02245, 0.00014), "w0": (-1.027, 0.0925)}, 12.77,
     {"steps_mult": 4}),
    ("bao.desi_cmb", "w0wacdm", {"compression": "chen"},
     {"rd": (147.30, 0.55), "H0": (63.88, 2.02), "Om": (0.3535, 0.0234),
      "Obh2": (0.02233, 0.00014), "w0": (-0.455, 0.2405),
      "wa": (-1.658, 0.706)}, 6.45, {"steps_mult": 4}),
    # sn/union3_cmb.py:229-257 wCDM / wzCDM / w0waCDM
    ("sn.union3_cmb", "wcdm", {},
     {"H0": (65.19, 1.21), "Om": (0.336, 0.013), "Obh2": (0.02240, 0.000145),
      "w0": (-0.924, 0.0425), "dM": (-0.220, 0.094)}, 23.2),
    ("sn.union3_cmb", "wzcdm", {},
     {"H0": (65.30, 1.07), "Om": (0.335, 0.012), "Obh2": (0.02240, 0.000145),
      "w0": (-0.872, 0.0665), "dM": (-0.212, 0.0915)}, 22.5),
    ("sn.union3_cmb", "w0wacdm", {},
     {"H0": (66.51, 1.35), "Om": (0.324, 0.0135), "Obh2": (0.02239, 0.000145),
      "w0": (-0.689, 0.1575), "wa": (-1.106, 0.7435), "dM": (-0.160, 0.0995)},
     21.4),
    # cosmic_chronometers/cc_union3.py:202-222 wCDM / wzCDM
    ("cc.cc_union3", "wcdm", {},
     {"f_cc": (0.71, 0.09), "dM": (-0.179, 0.1245), "H0": (66.4, 2.7),
      "Om": (0.306, 0.052), "w0": (-0.85, 0.13)}, 52.28),
    ("cc.cc_union3", "wzcdm", {},
     {"f_cc": (0.71, 0.09), "dM": (-0.180, 0.1245), "H0": (66.3, 2.7),
      "Om": (0.321, 0.034), "w0": (-0.84, 0.13)}, 51.97),
    # quasars/qsr_union3.py:225-246 wCDM / wzCDM
    ("qsr.union3", "wcdm", {},
     {"dM_qsr": (-0.103, 0.0915), "s": (0.387, 0.068), "dM": (-0.065, 0.0885),
      "Om": (0.357, 0.068), "w0": (-0.963, 0.193)}, 43.39),
    ("qsr.union3", "wzcdm", {},
     {"dM_qsr": (-0.100, 0.0915), "s": (0.390, 0.0675), "dM": (-0.062, 0.0885),
      "Om": (0.352, 0.049), "w0": (-0.911, 0.1825)}, 42.85),
]


def run_case(name, model, kwargs, published, chi2_pub, extra=None, quick=False,
             device="cuda"):
    """Sample one case and compare its medians with the published ones."""
    import torch

    from cosmax_torch.configs import get_preset
    from cosmax_torch.report import summarize
    from cosmax_torch.samplers import EnsembleSampler
    from cosmax_torch.samplers.ensemble import uniform_init

    extra = extra or {}
    fit = get_preset(name, model, fast=True, device=device, **kwargs)
    # the sweep's own sampling noise must sit far below the 0.1-sigma
    # target: at least 512 walkers x 3000 steps (tools/validate.py)
    n_walkers = min(fit.n_walkers, 128) if quick else max(fit.n_walkers, 512)
    n_walkers += n_walkers % 2
    n_steps = min(fit.n_steps, 1200) if quick else 3000 * extra.get("steps_mult", 1)
    seed = fit.seed or 0
    gen = torch.Generator(device=fit.device)
    gen.manual_seed(seed)
    init = uniform_init(gen, fit.spec.bounds, n_walkers, fit.dtype, fit.device)
    sampler = EnsembleSampler(fit.log_prob(), n_walkers, fit.spec.dim, moves=fit.moves)
    t0 = time.perf_counter()
    _, chain = sampler.run(init, n_steps, seed=seed + 1)
    chain.samples.cpu()  # waits for the device
    dt = time.perf_counter() - t0
    discard = min(fit.burn_in, n_steps // 4) if quick else max(fit.burn_in, n_steps // 3)
    summ = summarize(fit, chain, discard=discard)
    rows, worst = [], 0.0
    alt = extra.get("alt")
    worst_alt = 0.0 if alt else None
    for pname, (med_pub, sig_pub) in published.items():
        got = summ["params"][pname]
        z = abs(got["median"] - med_pub) / sig_pub
        worst = max(worst, z)
        z_alt = None
        if alt and pname in alt["target"]:
            z_alt = abs(got["median"] - alt["target"][pname]) / sig_pub
            worst_alt = max(worst_alt, z_alt)
        rows.append((pname, med_pub, sig_pub, got["median"],
                     0.5 * (got["plus"] + got["minus"]), z, z_alt))
    return dict(
        preset=name, model=model, kwargs=kwargs, rows=rows, chi2_pub=chi2_pub,
        chi2_got=summ["chi2_total"], worst_z=worst, worst_z_alt=worst_alt,
        alt_label=alt["label"] if alt else None, walltime=dt,
        acceptance=summ["acceptance_fraction"], ess=summ["effective_samples"],
        walkers=n_walkers, steps=n_steps,
    )


def _label(case):
    return f"{case[0]}[{case[1]}]" + (str(case[2]) if case[2] else "")


def _table(results, card, quick):
    lines = [
        "# VALIDATION (port) -- posterior parity vs published reference results",
        "",
        f"Generated {time.strftime('%Y-%m-%d %H:%M UTC', time.gmtime())} by "
        f"`tools/torch_validate.py{' --quick' if quick else ''}` on {card}: each case "
        "sampled end to end through the port's fast path (`get_preset(fast=True)`, the "
        "fused log-prob kernel) with the preset's moves. `z` = |median - published| / "
        "sigma_published; the parity target is z <~ 0.1 (BASELINE.json), up to the "
        "published medians' rounding and the chains' noise (larger with --quick).",
        "",
        "| config | param | published | port | z |",
        "|---|---|---|---|---|",
    ]
    summary = []
    for r in results:
        if "error" in r:
            lines.append(f"| {r['preset']} [{r['model']}] | -- | ERROR {r['error']} | | |")
            continue
        label = f"{r['preset']} [{r['model']}]" + (f" {r['kwargs']}" if r["kwargs"] else "")
        for i, (pname, mp, sp, mg, sg, z, z_alt) in enumerate(r["rows"]):
            zcol = f"{z:.2f}" + (f" ({z_alt:.2f} vs {r['alt_label']})"
                                 if z_alt is not None else "")
            lines.append(f"| {label if i == 0 else ''} | {pname} | {mp:g} ± {sp:g} | "
                         f"{mg:.4f} ± {sg:.4f} | {zcol} |")
        chi2_pub = f"{r['chi2_pub']:g}" if r["chi2_pub"] is not None else "--"
        lines.append(f"| | chi2@median | {chi2_pub} | {r['chi2_got']:.2f} | |")
        summary.append((label, r["worst_z"], r["worst_z_alt"], r["alt_label"], r["walltime"],
                        r["walkers"], r["steps"]))
    lines += ["", "## Summary", "", "| config | worst z | walkers x steps | seconds |",
              "|---|---|---|---|"]
    for label, worst, worst_alt, alt_label, dt, w, s in summary:
        wcol = f"{worst:.2f}" + (f" ({worst_alt:.2f} vs {alt_label})"
                                 if worst_alt is not None else "")
        lines.append(f"| {label} | {wcol} | {w} x {s} | {dt:.1f} |")
    return "\n".join(lines) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=os.path.join("build", "VALIDATION_torch.md"))
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", default=None, help="substring filter (not a regex)")
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = ap.parse_args(argv)
    import torch

    card = torch.cuda.get_device_name(0) if torch.device(args.device).type == "cuda" else "cpu"
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    results = []
    for case in CASES:
        label = _label(case)
        if args.only and args.only not in label:
            continue
        print(f"=== {label}", flush=True)
        try:
            r = run_case(*case, quick=args.quick, device=args.device)
            print(f"    worst |dmedian|/sigma_pub = {r['worst_z']:.3f}, chi2 {r['chi2_got']:.2f} "
                  f"(pub {r['chi2_pub']}), {r['walltime']:.1f}s", flush=True)
        except Exception as e:
            import traceback

            traceback.print_exc()
            r = dict(preset=case[0], model=case[1], error=str(e))
        results.append(r)
        # rewritten after every case, so that a cut sweep keeps what it ran
        with open(args.out + ".results.json", "w") as f:
            json.dump(results, f, default=float)
        with open(args.out, "w") as f:
            f.write(_table(results, card, args.quick))
    print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
