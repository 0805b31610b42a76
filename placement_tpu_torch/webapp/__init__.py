"""The port's web app: its data layer (``data.py``, no Streamlit) and the
Streamlit app over it (``app/``; ``streamlit run
placement_tpu_torch/webapp/app/home.py``)."""

from placement_tpu_torch.webapp.data import (
    CURVE_COLUMNS, RunSummary, comparison_curves, list_runs, load_run)

__all__ = ["CURVE_COLUMNS", "RunSummary", "comparison_curves", "list_runs",
           "load_run"]
