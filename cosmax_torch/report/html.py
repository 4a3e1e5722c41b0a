"""Self-contained interactive HTML Hubble diagram (counterpart of
``cosmax/report/html.py``; numpy only, the same bytes for the same
inputs).

The reference Hubble diagram (sn/plotting.py:8-41) attaches a
``CheckButtons`` widget that toggles the error bars on a live GUI
canvas. Runs on a card are headless, so the port renders the same
interaction as a standalone HTML file: inline SVG (no external assets,
no JS libraries) with a real checkbox that toggles the error-bar layer.
Open it in any browser; nothing to install.
"""

import html as _html

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ font: 14px system-ui, sans-serif; margin: 1.2em; }}
 .controls {{ margin: 0.6em 0; user-select: none; }}
 svg {{ background: #fff; border: 1px solid #ccc; }}
</style></head>
<body>
<h3>{title}</h3>
<div class="controls">
 <label><input type="checkbox" id="errbars" checked
  onchange="document.getElementById('errorbar-layer').style.visibility =
            this.checked ? 'visible' : 'hidden'"> Error Bars</label>
</div>
{svg}
</body></html>
"""


def _log_ticks(lo, hi):
    ticks = []
    d = 10.0 ** np.floor(np.log10(lo))
    while d <= hi:
        for m in (1, 2, 5):
            v = m * d
            if lo <= v <= hi:
                ticks.append(v)
        d *= 10.0
    return ticks or [lo, hi]


def hubble_diagram_html(
    z,
    obs_mag,
    err,
    theory_z,
    theory_mag,
    path,
    title="Hubble diagram",
    x_scale="log",
    y_label="Distance modulus (mag)",
):
    """Write an interactive Hubble diagram to ``path``.

    Mirrors sn/plotting.py:8-41: data scatter, model curve, toggleable
    error bars (checkbox, initially on), log or linear redshift axis.
    Returns ``path``.
    """
    z = np.asarray(z, dtype=float)
    obs = np.asarray(obs_mag, dtype=float)
    err = np.broadcast_to(np.asarray(err, dtype=float), z.shape)
    tz = np.asarray(theory_z, dtype=float)
    tm = np.asarray(theory_mag, dtype=float)

    w, h = 840, 520
    ml, mr, mt, mb = 64, 16, 10, 44  # margins
    log = x_scale == "log"

    def xt(v):
        vv = np.log10(v) if log else v
        lo = np.log10(x_lo) if log else x_lo
        hi = np.log10(x_hi) if log else x_hi
        return ml + (vv - lo) / (hi - lo) * (w - ml - mr)

    def yt(v):
        return mt + (y_hi - v) / (y_hi - y_lo) * (h - mt - mb)

    x_lo, x_hi = float(z.min()) * 0.9, float(z.max()) * 1.1
    y_lo = float(min(obs.min(), tm.min())) - 1.0
    y_hi = float(max(obs.max(), tm.max())) + 1.0

    parts = [
        f'<svg width="{w}" height="{h}" viewBox="0 0 {w} {h}" '
        'xmlns="http://www.w3.org/2000/svg">'
    ]
    # axes + ticks
    parts.append(
        f'<rect x="{ml}" y="{mt}" width="{w - ml - mr}" '
        f'height="{h - mt - mb}" fill="none" stroke="#444"/>'
    )
    xticks = _log_ticks(x_lo, x_hi) if log else np.linspace(x_lo, x_hi, 6)
    for v in xticks:
        px = xt(v)
        parts.append(
            f'<line x1="{px:.1f}" y1="{h - mb}" x2="{px:.1f}" '
            f'y2="{h - mb + 5}" stroke="#444"/>'
            f'<text x="{px:.1f}" y="{h - mb + 18}" font-size="11" '
            f'text-anchor="middle">{v:g}</text>'
        )
        parts.append(
            f'<line x1="{px:.1f}" y1="{mt}" x2="{px:.1f}" y2="{h - mb}" '
            'stroke="#ddd" stroke-dasharray="3,3"/>'
        )
    for v in np.linspace(y_lo, y_hi, 7):
        py = yt(v)
        parts.append(
            f'<line x1="{ml - 5}" y1="{py:.1f}" x2="{ml}" y2="{py:.1f}" '
            f'stroke="#444"/>'
            f'<text x="{ml - 8}" y="{py + 4:.1f}" font-size="11" '
            f'text-anchor="end">{v:.1f}</text>'
        )
        parts.append(
            f'<line x1="{ml}" y1="{py:.1f}" x2="{w - mr}" y2="{py:.1f}" '
            'stroke="#ddd" stroke-dasharray="3,3"/>'
        )
    parts.append(
        f'<text x="{(ml + w - mr) / 2}" y="{h - 8}" font-size="12" '
        'text-anchor="middle">Redshift (z)</text>'
        f'<text x="14" y="{(mt + h - mb) / 2}" font-size="12" '
        f'text-anchor="middle" transform="rotate(-90 14 '
        f'{(mt + h - mb) / 2})">{_html.escape(y_label)}</text>'
    )
    # error-bar layer (toggleable, id consumed by the checkbox JS)
    eb = ['<g id="errorbar-layer" stroke="#1f77b4" stroke-opacity="0.4">']
    for zi, oi, ei in zip(z, obs, err):
        px, y1, y2 = xt(zi), yt(oi - ei), yt(oi + ei)
        eb.append(
            f'<line x1="{px:.1f}" y1="{y1:.1f}" x2="{px:.1f}" y2="{y2:.1f}"/>'
        )
    eb.append("</g>")
    parts.extend(eb)
    # data scatter
    pts = [
        f'<circle cx="{xt(zi):.1f}" cy="{yt(oi):.1f}" r="1.6"/>'
        for zi, oi in zip(z, obs)
    ]
    parts.append(
        '<g fill="#1f77b4" fill-opacity="0.6">' + "".join(pts) + "</g>"
    )
    # model curve
    order = np.argsort(tz)
    d = " ".join(
        f"{xt(tz[i]):.1f},{yt(tm[i]):.1f}" for i in order
    )
    parts.append(
        f'<polyline points="{d}" fill="none" stroke="#d62728" '
        'stroke-width="1.5"/>'
    )
    parts.append("</svg>")

    doc = _PAGE.format(title=_html.escape(title), svg="".join(parts))
    with open(path, "w") as f:
        f.write(doc)
    return path
