"""Embed TensorBoard in a Streamlit page (the port app's own copy of the
JAX package's ``web_app/streamlit_tensorboard.py``; reference:
web_app/streamlit_tensorboard.py:12-90).

Starts (or reuses) a TensorBoard server for a logdir via
``tensorboard.manager`` and injects it as an iframe.
"""

from __future__ import annotations


def st_tensorboard(logdir: str, port: int = 8530, width: int = 1080,
                   height: int = 600):
    import streamlit.components.v1 as components
    from tensorboard import manager

    start_args = ["--logdir", logdir, "--port", str(port), "--bind_all"]
    start = manager.start(start_args)
    if isinstance(start, (manager.StartLaunched, manager.StartReused)):
        url_port = start.info.port
    else:  # StartFailed: surface the reason instead of a blank iframe
        import streamlit as st
        st.error(f"TensorBoard failed to start: {start}")
        return None
    return components.iframe(f"http://localhost:{url_port}", width=width,
                             height=height)
