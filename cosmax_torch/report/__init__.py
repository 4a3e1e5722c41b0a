"""Posterior summaries."""

from cosmax_torch.report.summary import format_summary, summarize

__all__ = ["format_summary", "summarize"]
