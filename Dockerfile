# Apertis serving/training image for NVIDIA GPU hosts (reference:
# Dockerfile): install the framework with JAX's CUDA 12 build and launch the
# AI Studio web UI by default. Run with the NVIDIA container runtime.
FROM python:3.12-slim

WORKDIR /app

RUN apt-get update && apt-get install -y --no-install-recommends \
        git build-essential && \
    rm -rf /var/lib/apt/lists/*

COPY setup.py README.md ./
COPY apertis_llm_tpu ./apertis_llm_tpu
COPY examples ./examples

# JAX with its CUDA 12 plugin (the pip wheels bundle CUDA and cuDNN).
RUN pip install --no-cache-dir -U pip && \
    pip install --no-cache-dir "jax[cuda12]" && \
    pip install --no-cache-dir .[hf,ui,data]

# Bake a small test model so the UI is usable immediately (same bootstrap as
# the reference image, Dockerfile:35-40).
RUN python - <<'EOF'
import jax
from apertis_llm_tpu.models.convert import save_pretrained_weights
from apertis_llm_tpu.models.factory import build_model_config
from apertis_llm_tpu.models.params import init_params
from apertis_llm_tpu.utils.vocab import create_minimal_vocab_file
config = build_model_config("10M", vocab_size_override=32000)
params = init_params(jax.random.PRNGKey(0), config)
save_pretrained_weights(params, config, "models/test_model")
create_minimal_vocab_file("models/test_model/vocab.json", size=100)
EOF

EXPOSE 7860
HEALTHCHECK --interval=30s --timeout=10s --retries=3 \
    CMD python -c "import urllib.request; urllib.request.urlopen('http://localhost:7860')" || exit 1

CMD ["apertis", "chat", "--model-path", "models/test_model", "--web", "--port", "7860"]
