#!/usr/bin/env bash
# Apertis installer (reference: install.sh).
# Installs the package with the right JAX build for the detected platform.
set -euo pipefail

PYTHON=${PYTHON:-python3}

echo "== Apertis installer =="
$PYTHON -c "import sys; assert sys.version_info >= (3, 10), 'Python >= 3.10 required'"

EXTRAS="hf,ui,data"
if [[ "${1:-}" == "--dev" ]]; then
    EXTRAS="$EXTRAS,dev,torch-interop"
fi

if command -v nvidia-smi >/dev/null 2>&1 && nvidia-smi -L >/dev/null 2>&1; then
    echo "NVIDIA GPU detected: installing jax[cuda12]"
    $PYTHON -m pip install -U "jax[cuda12]"
else
    echo "No NVIDIA GPU detected: installing CPU jax (the framework still runs;"
    echo "multi-device tests use virtual CPU devices)"
    $PYTHON -m pip install -U jax
fi

$PYTHON -m pip install -e ".[$EXTRAS]"

echo
echo "Install complete. Quick start:"
echo "  apertis create-model --target-params 125M --output-dir models/my_model"
echo "  apertis chat --model-path models/my_model --web"
