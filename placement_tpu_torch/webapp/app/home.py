"""Streamlit home page of the port's web app (counterpart of the JAX
package's ``web_app/home.py``; reference: web_app/home.py).

Run with:  streamlit run placement_tpu_torch/webapp/app/home.py
Needs streamlit, which the port's package does not depend on.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", ".."))

try:
    import streamlit as st
except ImportError as e:  # pragma: no cover - optional dependency
    raise SystemExit(
        "The web app needs streamlit (pip install streamlit); the port "
        "does not depend on it.") from e

st.set_page_config(page_title="GPU Component Placement", page_icon="🔲",
                   layout="wide")

st.title("RL Component Placement — PyTorch/CUDA edition")
st.markdown(
    """
A reinforcement-learning framework for PCB component placement, in PyTorch
with hand-written CUDA kernels (`placement_tpu_torch/`).

Use the pages in the sidebar:

1. **Trained agents** — browse past training runs, their configs, learning
   curves, and replay placement rollouts.
2. **Train new agent** — configure environment and model hyperparameters and
   launch a PPO training run on the GPU (or the CPU), with live reward
   curves.
3. **Comparison analysis** — overlay reward / wirelength / intersection
   curves across runs.

The environment suite has four variants of increasing complexity — square,
rectangular, rectangular-with-pins, and pin-spatial — all implemented as one
batched stepper over `[B, ...]` tensors (see `placement_tpu_torch/env/`).
"""
)
