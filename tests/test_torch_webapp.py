"""The port's web app: its data layer (``placement_tpu_torch.webapp.data``)
on runs that the port's ``Trainer`` wrote, and its Streamlit pages
(``placement_tpu_torch/webapp/app``) executed under a stub of streamlit.

* The cases of ``tests/tooling/test_webapp_data.py`` on port runs (a
  square run of 2 iterations, then a rectangle_pin run of 1 with
  rollouts); the JAX package's data layer reads the same runs to the same
  summaries and curves.
* The stub of ``tests/tooling/test_webapp_pages.py`` (copied: that module
  imports the JAX package), extended with a stub of
  ``tensorboard.manager``: widgets return their defaults, buttons False,
  ``st.stop()`` raises. The home page, the three pages and the
  TensorBoard embed execute over an empty results root (the pages stop
  early) and over the port runs (every page runs to its end: the run
  list, the rollout replay through ``render``, the curves, TensorBoard).
  Executed in a fresh process, they import no ``jax``, ``flax`` or
  ``placement_tpu`` module.

The JAX package is imported only inside the test that compares the two
data layers, so the fresh process imports only the port.
"""

import dataclasses
import importlib.util
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from placement_tpu_torch.agent.ppo import PPOConfig
from placement_tpu_torch.agent.trainer import Trainer
from placement_tpu_torch.viz.rollout import generate_rollouts
from placement_tpu_torch.webapp import data
from placement_tpu_torch.webapp.data import (
    CURVE_COLUMNS, comparison_curves, list_runs, load_run)

REPO = pathlib.Path(__file__).resolve().parents[1]
APP = REPO / "placement_tpu_torch" / "webapp" / "app"
PAGES = sorted((APP / "pages").glob("*.py"))
SCRIPTS = [APP / "home.py", *PAGES, APP / "streamlit_tensorboard.py"]
TINY = PPOConfig(num_envs=4, unroll_length=4, minibatch_size=8,
                 num_sgd_iter=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs_root(tmp_path_factory):
    """A results root with two port runs: ``PPO_square_a`` (2
    iterations), then ``PPO_rectangle_pin_b`` (1 iteration, rollouts
    exported: the newest, which the Trained-agents page shows first);
    returns (root, {run name: the rows its Trainer logged})."""
    root = str(tmp_path_factory.mktemp("runs"))
    logged = {}
    for model_type, name, iters in (("square", "PPO_square_a", 2),
                                    ("rectangle_pin", "PPO_rectangle_pin_b",
                                     1)):
        trainer = Trainer(model_type, results_root=root, ppo_config=TINY,
                          run_name=name, use_tensorboard=False,
                          device="cpu")
        rows = []
        result = trainer.run(num_iterations=iters,
                             on_iteration=lambda it, row: rows.append(row))
        if model_type == "rectangle_pin":
            generate_rollouts(trainer, state=result.state, num_samples=1)
        trainer.close()
        logged[name] = rows
    return root, logged


def test_list_runs_and_curves(runs_root):
    root, logged = runs_root
    runs = list_runs(root)
    assert [r.name for r in runs] == ["PPO_rectangle_pin_b", "PPO_square_a"]
    by_name = {r.name: r for r in runs}
    pin = by_name["PPO_rectangle_pin_b"]
    assert pin.model_type == "rectangle_pin"
    assert pin.num_iterations == 1
    assert pin.has_rollouts
    assert pin.final_reward_mean == pytest.approx(
        logged[pin.name][-1]["episode_reward_mean"], rel=1e-6)
    assert pin.input_params                     # the 1-row config CSV
    assert pin.env_config["height"] == 10
    sq = by_name["PPO_square_a"]
    assert sq.num_iterations == 2 and not sq.has_rollouts
    assert load_run(sq.path) == sq

    curves = comparison_curves([r.path for r in runs])
    assert set(curves) == {"PPO_square_a", "PPO_rectangle_pin_b"}
    c = curves["PPO_rectangle_pin_b"]
    assert set(c) == {"training_iteration", *CURVE_COLUMNS}
    np.testing.assert_array_equal(c["training_iteration"], [1.0])
    s = curves["PPO_square_a"]
    np.testing.assert_array_equal(s["training_iteration"], [1.0, 2.0])
    np.testing.assert_allclose(
        s["episode_reward_mean"],
        [row["episode_reward_mean"] for row in logged["PPO_square_a"]],
        rtol=1e-6)


def test_list_runs_empty(tmp_path):
    assert list_runs(str(tmp_path)) == []


def test_jax_data_layer_reads_port_runs_alike(runs_root):
    from placement_tpu.webapp import data as jax_data
    root, _ = runs_root
    got = [dataclasses.asdict(r) for r in list_runs(root)]
    want = [dataclasses.asdict(r) for r in jax_data.list_runs(root)]
    assert got == want
    paths = [r["path"] for r in got]
    got_c, want_c = comparison_curves(paths), jax_data.comparison_curves(
        paths)
    assert set(got_c) == set(want_c)
    for name in want_c:
        assert set(got_c[name]) == set(want_c[name])
        for col in want_c[name]:
            np.testing.assert_array_equal(got_c[name][col],
                                          want_c[name][col])


# ---------------------------------------------------------------------------
# The streamlit stub (copied from tests/tooling/test_webapp_pages.py, plus a
# tensorboard.manager stub so that a page with runs reaches its embed)
# ---------------------------------------------------------------------------

class StopPage(Exception):
    """Stand-in for streamlit's ScriptControlException."""


class _Elem:
    """Placeholder / container element: context manager + chainable API."""

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def __call__(self, *a, **k):
        return self

    def __getattr__(self, name):
        return _widget(name)

    def __iter__(self):
        return iter(())


def _widget(name):
    def call(*args, **kwargs):
        if name == "stop":
            raise StopPage()
        if name in ("selectbox", "radio", "select_slider"):
            opts = list(args[1]) if len(args) > 1 else []
            default = kwargs.get("index")
            if name == "select_slider" and len(args) > 2:
                return args[2]
            if default is not None and opts:
                return opts[default]
            return opts[0] if opts else None
        if name == "slider":
            if len(args) > 3:
                return args[3]
            return kwargs.get("value", args[1] if len(args) > 1 else 0)
        if name == "number_input":
            return kwargs.get("value", args[1] if len(args) > 1 else 0)
        if name == "text_input":
            return kwargs.get("value", "")
        if name in ("checkbox", "toggle", "button", "form_submit_button"):
            return kwargs.get("value", False)
        if name == "multiselect":
            return kwargs.get("default", [])
        if name == "columns":
            n = args[0]
            n = len(n) if isinstance(n, (list, tuple)) else int(n)
            return [_Elem() for _ in range(n)]
        if name == "tabs":
            return [_Elem() for _ in args[0]]
        return _Elem()
    return call


class _Launched:
    def __init__(self):
        self.info = types.SimpleNamespace(port=6006)


def stub_modules():
    """{module name: stub} for streamlit, its components and
    ``tensorboard.manager`` (``start`` reports a launched server and
    starts none)."""
    st = types.ModuleType("streamlit")
    st.__getattr__ = lambda name: (_Elem() if name in ("sidebar",)
                                   else _widget(name))
    comps = types.ModuleType("streamlit.components")
    v1 = types.ModuleType("streamlit.components.v1")
    v1.iframe = _widget("iframe")
    v1.html = _widget("html")
    comps.v1 = v1
    st.components = comps
    tb = types.ModuleType("tensorboard")
    manager = types.ModuleType("tensorboard.manager")
    manager.StartLaunched = _Launched
    manager.StartReused = type("StartReused", (_Launched,), {})
    manager.start = lambda args: _Launched()
    tb.manager = manager
    return {"streamlit": st, "streamlit.components": comps,
            "streamlit.components.v1": v1, "tensorboard": tb,
            "tensorboard.manager": manager}


def exec_script(path: pathlib.Path):
    """Execute a page as streamlit would: top to bottom, ``st.stop()`` an
    early end."""
    spec = importlib.util.spec_from_file_location(
        f"webapp_smoke_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    except StopPage:
        pass
    return mod


@pytest.fixture()
def stub_streamlit(monkeypatch, tmp_path):
    import matplotlib
    matplotlib.use("Agg")
    for name, mod in stub_modules().items():
        monkeypatch.setitem(sys.modules, name, mod)
    monkeypatch.setattr(data, "DEFAULT_RESULTS_ROOT", str(tmp_path))
    monkeypatch.syspath_prepend(str(REPO))


def test_pages_exist():
    assert [p.name for p in PAGES] == [
        "1_Trained_agents.py", "2_Train_new_agent.py",
        "3_Comparison_analysis.py"]
    assert not (APP / "__init__.py").exists()
    assert not (APP / "pages" / "__init__.py").exists()


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda p: p.stem)
def test_script_executes_under_stub_without_runs(stub_streamlit, script):
    exec_script(script)


@pytest.mark.parametrize("page", PAGES, ids=lambda p: p.stem)
def test_page_executes_under_stub_over_port_runs(stub_streamlit, runs_root,
                                                 monkeypatch, page):
    """Over the port runs; the Trained-agents page replays the newest
    run's rollout through ``render``."""
    from placement_tpu_torch.viz import grid
    drawn = []
    real = grid.render
    monkeypatch.setattr(grid, "render",
                        lambda *a, **k: drawn.append(a) or real(*a, **k))
    monkeypatch.setattr(data, "DEFAULT_RESULTS_ROOT", runs_root[0])
    exec_script(page)
    if page.stem == "1_Trained_agents":
        assert len(drawn) == 1 and drawn[0][:2] == (10, 10)


def test_tensorboard_embed_importable(stub_streamlit):
    mod = exec_script(APP / "streamlit_tensorboard.py")
    assert callable(mod.st_tensorboard)


_FRESH = """
import sys
from tests.test_torch_webapp import SCRIPTS, exec_script, stub_modules
sys.modules.update(stub_modules())
import placement_tpu_torch.webapp.data as data
data.DEFAULT_RESULTS_ROOT = sys.argv[1]
for script in SCRIPTS:
    exec_script(script)
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'placement_tpu'))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_app_imports_no_jax(runs_root):
    """Every script over the port runs, in a fresh process: no module of
    JAX, Flax or the JAX package is imported."""
    proc = subprocess.run(
        [sys.executable, "-c", _FRESH, runs_root[0]], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO), "MPLBACKEND": "Agg",
             "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
