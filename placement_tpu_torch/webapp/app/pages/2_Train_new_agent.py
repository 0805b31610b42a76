"""Train-new-agent page of the port's app (counterpart of the JAX
package's ``web_app/pages/2_Train_new_agent.py``; reference:
web_app/pages/2_…Train new agent.py): sidebar env + model hyperparameter
form -> a PPO run of the port's ``Trainer`` on the card (or the CPU) with
a live reward table/plot and progress bar -> rollout animation ->
TensorBoard. A cap-bound sampling regime that the Trainer's fidelity check
finds (``env/fidelity.py``) is shown as a warning on the page."""

import os
import sys
import time
import warnings

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "..", ".."))

import streamlit as st

st.set_page_config(page_title="Train new agent", layout="wide")
st.title("Train a new agent")

from placement_tpu_torch.agent.ppo import PPOConfig  # noqa: E402
from placement_tpu_torch.agent.trainer import Trainer  # noqa: E402
from placement_tpu_torch.utils.config import MODEL_TYPES  # noqa: E402
from placement_tpu_torch.viz.grid import render  # noqa: E402
from placement_tpu_torch.viz.rollout import (  # noqa: E402
    generate_rollouts, load_pickle)
from placement_tpu_torch.webapp.app.streamlit_tensorboard import (  # noqa: E402
    st_tensorboard)

with st.sidebar:
    st.header("Environment")
    model_type = st.selectbox("model type", sorted(MODEL_TYPES),
                              index=sorted(MODEL_TYPES).index(
                                  "rectangle_pin"))
    height = st.slider("grid height", 5, 30, 10)
    width = st.slider("grid width", 5, 30, 10)
    env_over = {"height": height, "width": width}
    if "pin" in model_type:
        env_over.update(
            min_component_h=st.slider("min component h", 1, 5, 2),
            max_component_h=st.slider("max component h", 1, 5, 2),
            min_component_w=st.slider("min component w", 1, 5, 2),
            max_component_w=st.slider("max component w", 1, 5, 2),
            min_num_components=st.slider("min components", 1, 40, 5),
            max_num_components=st.slider("max components", 1, 40, 5),
            min_num_nets=st.slider("min nets", 1, 10, 3),
            max_num_nets=st.slider("max nets", 1, 10, 3),
            min_num_pins_per_net=st.slider("min pins/net", 2, 10, 2),
            max_num_pins_per_net=st.slider("max pins/net", 2, 10, 6),
            net_distribution=st.slider("net distribution", 1, 9, 9),
            pin_spread=st.slider("pin spread", 1, 9, 9),
            reward_type=st.selectbox("reward type",
                                     ["centroid", "beam", "both"]),
            reward_beam_width=st.slider("beam width", 2, 6, 2),
            weight_wirelength=st.slider("wirelength weight", 0.0, 1.0, 0.5),
            weight_num_intersections=st.slider("intersection weight",
                                               0.0, 1.0, 0.5),
        )

    st.header("Model")
    # full control surface of the reference train page (~28 sidebar inputs,
    # web_app/pages/2_…Train new agent.py:143-330) plus the preset-specific
    # knobs the reference only exposes via config JSONs
    model_over = dict(
        num_conv_blocks=st.slider("conv blocks", 1, 4, 2),
        num_conv_filters=st.slider("conv filters", 1, 16, 3),
        conv_kernel_size=st.slider("conv kernel", 2, 5, 3),
        max_pool=st.radio("max pool", (False, True), horizontal=True),
        max_pool_kernel_size=st.slider("max pool kernel", 2, 4, 2),
        component_feature_encoding_dimension=st.slider(
            "component enc dim", 4, 64, 16),
        pin_feature_encoding_dimension=st.slider("pin enc dim", 4, 64, 16),
        activation=st.selectbox("activation", ["relu", "tanh", "sigmoid"]),
    )
    if "attn" in model_type:
        model_over.update(
            attn_hidden_size=st.slider("attention hidden size", 4, 64, 16),
            attn_hidden_size_pin=st.slider("pin attention hidden size",
                                           4, 64, 16),
        )
    if "factorized" in model_type:
        model_over.update(factorization=st.selectbox(
            "factorization order", ["orientation", "coordinates"]))
    if "spatial" in model_type:
        model_over.update(
            num_conv_blocks_component_grid=st.slider(
                "component-grid conv blocks", 1, 4, 1),
            num_conv_filters_component_grid=st.slider(
                "component-grid conv filters", 1, 16, 3),
            conv_kernel_size_component_grid=st.slider(
                "component-grid conv kernel", 2, 5, 3),
            component_attn_hidden_size=st.slider(
                "component attention hidden size", 4, 64, 16),
        )

    st.header("PPO")
    iterations = st.slider("training iterations", 1, 200, 10)
    num_envs = st.select_slider("parallel envs",
                                [32, 64, 128, 256, 512, 1024], 128)
    unroll = st.select_slider("unroll length", [8, 16, 32, 64], 32)
    lr = st.number_input("learning rate", value=5e-5, format="%.1e")
    # RLlib-parity default is 30; fewer epochs make an iteration cheaper
    # (python -m placement_tpu_torch.tools.train_profile splits it)
    num_sgd_iter = st.select_slider("SGD epochs per iteration",
                                    [1, 5, 10, 20, 30], 30)
    # Gated terminal routing: on big boards the routing dominates the
    # rollout's env step; gating computes it only for the boards that
    # finish each step (values match to one f32 ulp, env/pooled.py; python
    # -m placement_tpu_torch.tools.pooled_profile prices the routing).
    # Default on for large grids.
    gate_routing = st.checkbox(
        "gated terminal routing (faster on big boards)",
        value=("pin" in model_type and height * width > 300))
    seed = st.number_input("seed", value=0, step=1)
    # the card by default; the Trainer raises without one
    device = st.selectbox("device", ["cuda", "cpu"])
    go = st.button("Train", type="primary")

if go:
    route_budget = (max(int(num_envs) // 8, 16)
                    if gate_routing and "pin" in model_type else None)
    cfg = PPOConfig(num_envs=int(num_envs), unroll_length=int(unroll),
                    lr=float(lr), num_sgd_iter=int(num_sgd_iter),
                    route_budget=route_budget)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", UserWarning)
        trainer = Trainer(model_type, ppo_config=cfg, env_overrides=env_over,
                          model_overrides=model_over, device=device)
    for w in caught:       # the sampling-fidelity check (env/fidelity.py)
        st.warning(str(w.message))
    st.write(f"Run dir: `{trainer.run_dir}`")
    progress = st.progress(0.0, "starting…")
    chart = st.empty()
    table = st.empty()
    rows = []

    def on_iteration(it, row):
        rows.append({"iteration": it,
                     "episode_reward_mean": row["episode_reward_mean"]})
        progress.progress(it / iterations, f"iteration {it}/{iterations}")
        chart.line_chart(rows, x="iteration", y="episode_reward_mean")
        table.dataframe(rows[-10:])

    result = trainer.run(num_iterations=int(iterations), seed=int(seed),
                         on_iteration=on_iteration)
    st.success(f"done: episode_reward_mean = "
               f"{result.final_metrics.get('episode_reward_mean'):.4f}")

    if "pin" in model_type:
        generate_rollouts(trainer, state=result.state)
        _, actions, components = load_pickle(trainer.run_dir)
        st.subheader("Rollout animation")
        frame = st.empty()
        for t in range(1, len(actions[0]) + 1):
            frame.pyplot(render(height, width, components[0][:t],
                                actions[0][:t],
                                title=f"step {t}/{len(actions[0])}"))
            time.sleep(2)

    st.subheader("TensorBoard")
    st_tensorboard(trainer.run_dir)
    trainer.close()
