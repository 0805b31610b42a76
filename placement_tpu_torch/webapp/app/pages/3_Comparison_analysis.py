"""Comparison page of the port's app (counterpart of the JAX package's
``web_app/pages/3_Comparison_analysis.py``; reference: web_app/pages/3_…
Comparison analysis.py:31-80): multi-select runs and overlay reward /
normalized-wirelength / intersections learning curves."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "..", ".."))

import streamlit as st

from placement_tpu_torch.webapp.data import (
    CURVE_COLUMNS, comparison_curves, list_runs)

st.set_page_config(page_title="Comparison analysis", layout="wide")
st.title("Comparison analysis")

runs = list_runs()
if not runs:
    st.info("No training runs found.")
    st.stop()

selected = st.multiselect(
    "Agents to compare", [r.name for r in runs],
    default=[r.name for r in runs[:2]])
paths = {r.name: r.path for r in runs}
curves = comparison_curves([paths[n] for n in selected])

TITLES = {
    "episode_reward_mean": "Episode reward (mean)",
    "custom_metrics/normalized_wirelengths_mean":
        "Normalized wirelength (mean)",
    "custom_metrics/num_intersections_mean": "Wire intersections (mean)",
}

for col in CURVE_COLUMNS:
    data = {name: c[col] for name, c in curves.items() if col in c}
    if not data:
        continue
    st.subheader(TITLES[col])
    st.line_chart(data)
