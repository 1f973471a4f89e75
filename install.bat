@echo off
REM Apertis installer for Windows (reference: install.bat).
REM JAX's CUDA build is Linux-only; installs the CPU build, which runs
REM the full framework (multi-device tests use virtual CPU devices).

python -c "import sys; assert sys.version_info >= (3, 10)" || (
    echo Python 3.10+ required & exit /b 1)

python -m pip install -U jax
python -m pip install -e .[hf,ui,data]

echo.
echo Install complete. Quick start:
echo   apertis create-model --target-params 125M --output-dir models\my_model
echo   apertis chat --model-path models\my_model --web
