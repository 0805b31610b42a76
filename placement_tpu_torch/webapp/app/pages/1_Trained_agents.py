"""Trained-agents page of the port's app (counterpart of the JAX package's
``web_app/pages/1_Trained_agents.py``; reference: web_app/pages/1_…Trained
agents.py:33-120): list the port's runs newest first, show input
parameters and progress, replay pickled rollouts as a step-by-step
animation, and embed TensorBoard."""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "..", ".."))

import streamlit as st

from placement_tpu_torch.viz.grid import render
from placement_tpu_torch.viz.rollout import load_pickle
from placement_tpu_torch.webapp.app.streamlit_tensorboard import st_tensorboard
from placement_tpu_torch.webapp.data import list_runs

st.set_page_config(page_title="Trained agents", layout="wide")
st.title("Trained agents")

runs = list_runs()
if not runs:
    st.info("No training runs found. Train an agent first (page 2, or "
            "`python -m placement_tpu_torch.experiments.ppo --type "
            "rectangle_pin`).")
    st.stop()

names = [f"{r.name}  ({r.model_type}, {r.num_iterations} iters)"
         for r in runs]
idx = st.selectbox("Run", range(len(runs)), format_func=lambda i: names[i])
run = runs[idx]

left, right = st.columns(2)
with left:
    st.subheader("Input parameters")
    if run.input_params:
        st.dataframe(run.input_params)
    else:
        st.json(run.env_config)
with right:
    st.subheader("Progress")
    st.metric("iterations", run.num_iterations)
    if run.final_reward_mean is not None:
        st.metric("final episode_reward_mean",
                  f"{run.final_reward_mean:.4f}")

if run.has_rollouts:
    st.subheader("Rollout replay")
    _, actions, components = load_pickle(run.path)
    ep = st.slider("episode", 0, len(actions) - 1, 0)
    h = int(run.env_config.get("height", 10))
    w = int(run.env_config.get("width", 10))
    animate = st.checkbox("animate (2 s per placement)")
    frame = st.empty()
    if animate:
        for t in range(1, len(actions[ep]) + 1):
            fig = render(h, w, components[ep][:t], actions[ep][:t],
                         title=f"step {t}/{len(actions[ep])}")
            frame.pyplot(fig)
            time.sleep(2)
    else:
        frame.pyplot(render(h, w, components[ep], actions[ep]))

st.subheader("TensorBoard")
st_tensorboard(run.path)
