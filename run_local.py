#!/usr/bin/env python3
"""One-command local launcher for the Apertis AI Studio.

The portable counterpart of the reference's Windows launcher
(reference: run_windows.py:191-292): check dependencies, make sure a model
exists (creating a small test model if not), launch the web UI, and open a
browser.
"""

import argparse
import importlib.util
import os
import sys
import webbrowser


def check_dependencies() -> bool:
    required = ["jax", "numpy", "optax"]
    optional = {"gradio": "web UI", "transformers": "HF tokenizers",
                "PIL": "image input"}
    ok = True
    for mod in required:
        if importlib.util.find_spec(mod) is None:
            print(f"ERROR: required dependency '{mod}' is missing. "
                  f"Install with: pip install -e .[hf,ui]")
            ok = False
    for mod, what in optional.items():
        if importlib.util.find_spec(mod) is None:
            print(f"note: optional dependency '{mod}' missing ({what}).")
    return ok


def ensure_model(model_dir: str) -> str:
    if os.path.exists(os.path.join(model_dir, "model.pt")) or \
       os.path.exists(os.path.join(model_dir, "pytorch_model.bin")):
        return model_dir
    print(f"No model at {model_dir}; creating a small test model...")
    import jax

    from apertis_llm_tpu.models.convert import save_torch_checkpoint
    from apertis_llm_tpu.models.factory import build_model_config
    from apertis_llm_tpu.models.params import init_params
    from apertis_llm_tpu.utils.vocab import create_minimal_vocab_file

    config = build_model_config("10M", vocab_size_override=32000)
    params = init_params(jax.random.PRNGKey(0), config)
    save_torch_checkpoint(params, config, model_dir, filename="model.pt")
    create_minimal_vocab_file(os.path.join(model_dir, "vocab.json"), size=100)
    return model_dir


def main() -> None:
    parser = argparse.ArgumentParser(description="Launch the Apertis AI Studio")
    parser.add_argument("--model-path", default="models/test_model")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--no-browser", action="store_true")
    args = parser.parse_args()

    if not check_dependencies():
        sys.exit(1)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    model_dir = ensure_model(args.model_path)

    if not args.no_browser:
        try:
            webbrowser.open(f"http://localhost:{args.port}")
        except Exception:
            pass

    from apertis_llm_tpu.inference.interface import ApertisInterface

    ApertisInterface(model_path=model_dir, web=True, port=args.port)


if __name__ == "__main__":
    main()
