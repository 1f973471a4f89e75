"""Gradio Blocks wiring smoke test WITHOUT gradio installed.

A stub `gradio` module records every component construction and every
`.click`/`.submit` binding made by ``inference.ui.launch_ui``; the test then
checks each binding's handler exists, its positional-parameter count matches
the declared input components, and the safely-callable handlers return the
right number of outputs. This pins the exact wiring bugs a real gradio
install would hit (arity mismatches, dead buttons) — the reference's live
app is src/inference/interface.py:552-1575."""

import inspect
import sys
import types
from unittest import mock

import pytest


class _Component:
    def __init__(self, *args, **kwargs):
        self.kwargs = kwargs
        STUB.components.append(self)

    def _bind(self, fn, inputs=None, outputs=None):
        if inputs is None:
            inputs = []
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        if outputs is None:
            outputs = []
        if not isinstance(outputs, (list, tuple)):
            outputs = [outputs]
        STUB.bindings.append((fn, list(inputs), list(outputs)))

    def click(self, fn, inputs=None, outputs=None):
        self._bind(fn, inputs, outputs)

    def submit(self, fn, inputs=None, outputs=None):
        self._bind(fn, inputs, outputs)


class _Ctx(_Component):
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _Blocks(_Ctx):
    def launch(self, **kwargs):
        STUB.launched.append(kwargs)


def _make_stub():
    g = types.ModuleType("gradio")
    g.Blocks = _Blocks
    for ctx in ("Tabs", "TabItem", "Row", "Accordion", "Column"):
        setattr(g, ctx, type(ctx, (_Ctx,), {}))
    for comp in ("Markdown", "Chatbot", "Textbox", "Button", "Image",
                 "Slider", "Number", "Checkbox", "Dropdown"):
        setattr(g, comp, type(comp, (_Component,), {}))
    g.components = []
    g.bindings = []
    g.launched = []
    return g


STUB = _make_stub()


@pytest.fixture()
def stub_gradio(monkeypatch):
    STUB.components.clear()
    STUB.bindings.clear()
    STUB.launched.clear()
    monkeypatch.setitem(sys.modules, "gradio", STUB)
    return STUB


def _launch(stub):
    from apertis_llm_tpu.inference.ui import launch_ui

    interface = mock.Mock()
    interface.chat.return_value = "hi"
    launch_ui(interface, port=7860)
    return interface


def test_all_five_tabs_build_and_launch(stub_gradio):
    _launch(stub_gradio)
    tab_count = sum(1 for c in stub_gradio.components
                    if type(c).__name__ == "TabItem")
    assert tab_count == 5
    assert stub_gradio.launched, "app.launch was never called"


def test_every_binding_arity_matches(stub_gradio):
    """Each .click/.submit handler's positional arg count == len(inputs)."""
    _launch(stub_gradio)
    assert len(stub_gradio.bindings) >= 10  # chat x3, 3 train tabs x2, models x2
    for fn, inputs, outputs in stub_gradio.bindings:
        assert callable(fn)
        sig = inspect.signature(fn)
        n_params = len([p for p in sig.parameters.values()
                        if p.kind in (p.POSITIONAL_ONLY,
                                      p.POSITIONAL_OR_KEYWORD)])
        assert n_params == len(inputs), (
            f"{getattr(fn, '__name__', fn)} takes {n_params} args but is "
            f"wired to {len(inputs)} input components")
        for comp in inputs + outputs:
            assert isinstance(comp, _Component), (
                f"{getattr(fn, '__name__', fn)} wired to a non-component")


def test_safe_handlers_return_matching_output_arity(stub_gradio):
    """Handlers that can run without a real model return exactly as many
    values as they have output components."""
    _launch(stub_gradio)

    def arity(result):
        return len(result) if isinstance(result, tuple) else 1

    ran = 0
    for fn, inputs, outputs in stub_gradio.bindings:
        name = getattr(fn, "__name__", "")
        if name == "chat":
            res = fn("", None, 10, 0.7, 50, 0.9, [])          # empty message
        elif name == "clear_chat":
            res = fn()
        elif name == "load_model":
            res = fn("", "")                                   # missing path
        elif name == "start_pretraining":
            res = fn(*[""] * 3, "125M", "standard_mha", False, False,
                     8, 2, False, "", 512, "out", 4, 5e-5, 1, 1, False)
        elif name == "start_finetuning":
            res = fn("", "", "", True, "gpt2", "t", 512, "out", 4,
                     5e-5, 1, 1, False)
        elif name == "<lambda>":                               # stop buttons
            res = fn()
        else:
            continue
        assert arity(res) == len(outputs), (
            f"{name} returned {arity(res)} values for {len(outputs)} outputs")
        ran += 1
    assert ran >= 8


def test_chat_roundtrip_through_binding(stub_gradio):
    """The chat binding drives ApertisInterface.chat and appends history."""
    interface = _launch(stub_gradio)
    chat_fns = [fn for fn, i, o in stub_gradio.bindings
                if getattr(fn, "__name__", "") == "chat"]
    history, cleared = chat_fns[0]("hello", None, 10, 0.7, 50, 0.9, [])
    assert history == [("hello", "hi")]
    assert cleared == ""
    interface.chat.assert_called_once()
