"""Posterior summaries and the HTML Hubble diagram. The figures are in
``cosmax_torch.report.plots``, which imports matplotlib: import it where
figures are drawn."""

from cosmax_torch.report.html import hubble_diagram_html
from cosmax_torch.report.summary import format_summary, summarize

__all__ = ["format_summary", "hubble_diagram_html", "summarize"]
