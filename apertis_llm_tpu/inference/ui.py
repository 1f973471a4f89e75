"""Apertis AI Studio — the Gradio web UI.

Five tabs mirroring the reference app (reference:
src/inference/interface.py:552-1575): Chat, Pre-training, Fine-tuning,
Absolute Zero Reasoner, Models. Training launches write a temp JSON config
and run ``train_from_config`` in a daemon thread with a per-job stop event,
exactly like the reference's thread-launched jobs (interface.py:1087-1563).

All handler logic lives on :class:`UIBackend` as plain methods (no gradio
types), so the behaviour is unit-testable without gradio installed; the
gradio layer in :func:`launch_ui` is a thin binding.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)


class TrainingJob:
    """A daemon-thread training job with a cooperative stop event."""

    def __init__(self, name: str):
        self.name = name
        self.stop_event = threading.Event()
        self.thread: Optional[threading.Thread] = None
        self.status_lock = threading.Lock()
        self._status: List[str] = []

    def append_status(self, line: str) -> None:
        with self.status_lock:
            self._status.append(line)

    def status(self) -> str:
        with self.status_lock:
            return "\n".join(self._status[-50:])

    def running(self) -> bool:
        return self.thread is not None and self.thread.is_alive()

    def start(self, target, *args) -> None:
        self.stop_event.clear()
        with self.status_lock:
            self._status = []

        def run():
            try:
                self.append_status(f"{self.name} started.")
                result = target(*args)
                if self.stop_event.is_set():
                    self.append_status(f"{self.name} stopped by user.")
                else:
                    self.append_status(f"{self.name} finished: "
                                       f"{json.dumps(result, default=str)[:500]}")
            except Exception as e:  # surfaced in the status box, not crashed UI
                logger.error("%s failed: %s", self.name, e, exc_info=True)
                self.append_status(f"{self.name} FAILED: {e}")

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def stop(self) -> str:
        if not self.running():
            return f"No {self.name} job is running."
        self.stop_event.set()
        return f"Stop requested for {self.name}; finishing current step..."


class UIBackend:
    """Gradio-free handler logic for the AI Studio tabs."""

    def __init__(self, interface):
        self.interface = interface
        self.pretrain_job = TrainingJob("Pre-training")
        self.finetune_job = TrainingJob("Fine-tuning")
        self.azr_job = TrainingJob("AZR training")

    # -- Chat tab -------------------------------------------------------
    def chat(self, message: str, image_path: Optional[str], max_new: int,
             temperature: float, top_k: int, top_p: float,
             history: List[Tuple[str, str]]):
        if not message.strip():
            return history, ""
        response = self.interface.chat(
            message=message, image_path=image_path, max_length=int(max_new),
            temperature=temperature, top_k=int(top_k), top_p=top_p)
        history = list(history) + [(message, response)]
        return history, ""

    def clear_chat(self):
        self.interface.reset_chat()
        return [], "", None

    # -- Models tab -----------------------------------------------------
    def load_model(self, model_path: str, vocab_override: str) -> str:
        if not model_path.strip():
            return "Provide a model path."
        try:
            self.interface.load_model_and_tokenizer_from_path(
                model_path.strip(), vocab_file_override=vocab_override.strip() or None)
            cfg = self.interface.config
            return (f"Loaded: {self.interface.actual_model_path_loaded}\n"
                    f"Tokenizer: {self.interface.actual_tokenizer_path_loaded}\n"
                    f"attention_type={cfg.attention_type}  hidden={cfg.hidden_size}  "
                    f"layers={cfg.num_hidden_layers}  heads={cfg.num_attention_heads}\n"
                    f"vocab={cfg.vocab_size}  multimodal={cfg.multimodal}  "
                    f"moe={cfg.use_expert_system}({cfg.num_experts})")
        except Exception as e:
            return f"Error loading model: {e}"

    def create_model(self, target_params: str, vocab_size: float,
                     multimodal: bool, use_expert_system: bool,
                     num_experts: float, experts_per_token: float,
                     attention_type: str, use_flash_attention: bool,
                     output_dir: str) -> str:
        try:
            import jax

            from apertis_llm_tpu.models.convert import save_torch_checkpoint
            from apertis_llm_tpu.models.factory import (
                build_model_config, estimate_model_parameters)
            from apertis_llm_tpu.models.params import init_params
            from apertis_llm_tpu.utils.vocab import create_minimal_vocab_file

            config = build_model_config(
                target_param_count=target_params or "125M",
                vocab_size_override=int(vocab_size) if vocab_size else 32000,
                multimodal=multimodal,
                use_expert_system=use_expert_system,
                num_experts_target_override=int(num_experts) if use_expert_system else None,
                experts_per_token_target_override=int(experts_per_token) if use_expert_system else None,
                attention_type_override=attention_type or None,
                use_flash_attention=use_flash_attention,
            )
            params = init_params(jax.random.PRNGKey(0), config)
            os.makedirs(output_dir, exist_ok=True)
            save_torch_checkpoint(params, config, output_dir, filename="model.pt")
            vocab_path = os.path.join(output_dir, "vocab.json")
            if not os.path.exists(vocab_path):
                create_minimal_vocab_file(vocab_path, size=4)
            actual = estimate_model_parameters(config)
            return (f"Model created in {output_dir} "
                    f"(~{actual/1e6:.2f}M params, H={config.hidden_size}, "
                    f"L={config.num_hidden_layers}).")
        except Exception as e:
            logger.error("create_model failed: %s", e, exc_info=True)
            return f"Error creating model: {e}"

    # -- training tabs --------------------------------------------------
    @staticmethod
    def _write_temp_config(config: Dict[str, Any]) -> str:
        fd, path = tempfile.mkstemp(suffix=".json", prefix="apertis_ui_cfg_")
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(config, f, indent=2)
        return path

    def start_pretraining(
        self, train_data: str, val_data: str, vocab_path: str,
        target_params: str, attention_type: str, multimodal: bool,
        use_expert_system: bool, num_experts: float, experts_per_token: float,
        use_flash_attention: bool, image_dir: str, max_length: float,
        output_dir: str, batch_size: float, learning_rate: float,
        num_epochs: float, grad_accum: float, use_wandb: bool,
    ) -> str:
        if self.pretrain_job.running():
            return "A pre-training job is already running."
        if not train_data.strip() or not vocab_path.strip():
            return "Train data path and vocab path are required."
        config = {
            "data_config": {
                "train_data_path": train_data.strip(),
                "val_data_path": val_data.strip() or None,
                "tokenizer_path": vocab_path.strip(),
                "max_length": int(max_length),
                "image_dir": image_dir.strip() or None,
            },
            "model_config": {
                "target_param_count": target_params or "125M",
                "attention_type": attention_type or "standard_mha",
                "multimodal": multimodal,
                "use_expert_system": use_expert_system,
                "num_experts": int(num_experts),
                "experts_per_token": int(experts_per_token),
                "use_flash_attention": use_flash_attention,
            },
            "training_config": {
                "task_type": "pretrain",
                "output_dir": output_dir or "output",
                "batch_size": int(batch_size),
                "learning_rate": float(learning_rate),
                "num_epochs": int(num_epochs),
                "gradient_accumulation_steps": int(grad_accum),
                "use_wandb": use_wandb,
            },
        }
        path = self._write_temp_config(config)
        from apertis_llm_tpu.training.pipeline import train_from_config

        self.pretrain_job.start(train_from_config, path,
                                self.pretrain_job.stop_event)
        return f"Pre-training launched (config: {path})."

    def start_finetuning(
        self, base_model_path: str, train_data: str, val_data: str,
        use_hf_tokenizer: bool, tokenizer_name: str, prompt_template: str,
        max_length: float, output_dir: str, batch_size: float,
        learning_rate: float, num_epochs: float, grad_accum: float,
        use_wandb: bool,
    ) -> str:
        if self.finetune_job.running():
            return "A fine-tuning job is already running."
        if not base_model_path.strip() or not train_data.strip():
            return "Base model path and train data path are required."
        config = {
            "data_config": {
                "train_data_path": train_data.strip(),
                "val_data_path": val_data.strip() or None,
                "tokenizer_path": tokenizer_name.strip(),
                "use_hf_tokenizer_for_finetune": use_hf_tokenizer,
                "prompt_template": prompt_template
                or "User: {instruction}\nAssistant: {output}",
                "max_length": int(max_length),
            },
            "model_config": {},
            "training_config": {
                "task_type": "finetune",
                "pretrained_model_path_for_finetune": base_model_path.strip(),
                "output_dir": output_dir or "output_ft",
                "batch_size": int(batch_size),
                "learning_rate": float(learning_rate),
                "num_epochs": int(num_epochs),
                "gradient_accumulation_steps": int(grad_accum),
                "use_wandb": use_wandb,
            },
        }
        path = self._write_temp_config(config)
        from apertis_llm_tpu.training.pipeline import train_from_config

        self.finetune_job.start(train_from_config, path,
                                self.finetune_job.stop_event)
        return f"Fine-tuning launched (config: {path})."

    def start_azr(
        self, tokenizer_name: str, hidden_size: float, num_layers: float,
        num_heads: float, intermediate_size: float, attention_type: str,
        num_iterations: float, tasks_per_iteration: float,
        checkpoint_interval: float, output_dir: str,
    ) -> str:
        if self.azr_job.running():
            return "An AZR job is already running."
        config = {
            "data": {"tokenizer_name": tokenizer_name or "gpt2"},
            "model": {
                "hidden_size": int(hidden_size),
                "num_hidden_layers": int(num_layers),
                "num_attention_heads": int(num_heads),
                "intermediate_size": int(intermediate_size),
                "attention_type": attention_type or "standard_mha",
            },
            "training": {"method": "azr", "output_dir": output_dir or "output_azr"},
            "azr": {
                "num_iterations": int(num_iterations),
                "tasks_per_iteration": int(tasks_per_iteration),
                "checkpoint_interval": int(checkpoint_interval),
            },
        }
        path = self._write_temp_config(config)
        from apertis_llm_tpu.training.azr_pipeline import train_from_config

        self.azr_job.start(train_from_config, path, self.azr_job.stop_event)
        return f"AZR training launched (config: {path})."


def launch_ui(interface, port: int = 7860, share: bool = False) -> None:
    """Build and launch the Gradio app (with port fallback,
    reference: interface.py:1566-1575)."""
    import gradio as gr

    backend = UIBackend(interface)

    with gr.Blocks(title="Apertis AI Studio") as app:
        gr.Markdown("# Apertis AI Studio")
        with gr.Tabs():
            with gr.TabItem("Chat"):
                chatbot = gr.Chatbot(height=500, label="Apertis Chat")
                with gr.Row():
                    msg = gr.Textbox(label="Message", scale=4)
                    send = gr.Button("Send", scale=1)
                clear = gr.Button("Clear Chat")
                image = gr.Image(label="Image (multimodal)", type="filepath")
                with gr.Accordion("Sampling", open=False):
                    max_new = gr.Slider(1, 1024, value=100, step=1,
                                        label="Max new tokens")
                    temp = gr.Slider(0.0, 2.0, value=0.7, label="Temperature")
                    top_k = gr.Slider(0, 200, value=50, step=1, label="Top-k")
                    top_p = gr.Slider(0.0, 1.0, value=0.9, label="Top-p")
                send.click(backend.chat,
                           [msg, image, max_new, temp, top_k, top_p, chatbot],
                           [chatbot, msg])
                msg.submit(backend.chat,
                           [msg, image, max_new, temp, top_k, top_p, chatbot],
                           [chatbot, msg])
                clear.click(backend.clear_chat, outputs=[chatbot, msg, image])

            with gr.TabItem("Pre-training"):
                tr_data = gr.Textbox(label="Train data (JSONL)")
                tr_val = gr.Textbox(label="Validation data (JSONL, optional)")
                tr_vocab = gr.Textbox(label="Vocab file (vocab.json)")
                tr_params = gr.Textbox(label="Target parameters", value="125M")
                tr_attn = gr.Dropdown(["standard_mha", "selective_ssm"],
                                      value="standard_mha", label="Attention type")
                tr_mm = gr.Checkbox(label="Multimodal")
                tr_moe = gr.Checkbox(label="Use Expert System")
                tr_ne = gr.Number(value=8, label="Num experts")
                tr_ept = gr.Number(value=2, label="Experts per token")
                tr_flash = gr.Checkbox(label="Use fused attention kernel")
                tr_imgdir = gr.Textbox(label="Image dir (multimodal)")
                tr_maxlen = gr.Number(value=512, label="Max length")
                tr_out = gr.Textbox(label="Output dir", value="output")
                tr_bs = gr.Number(value=4, label="Batch size")
                tr_lr = gr.Number(value=5e-5, label="Learning rate")
                tr_epochs = gr.Number(value=3, label="Epochs")
                tr_accum = gr.Number(value=4, label="Grad accumulation")
                tr_wandb = gr.Checkbox(label="Log to W&B")
                with gr.Row():
                    tr_start = gr.Button("Start Pre-training", variant="primary")
                    tr_stop = gr.Button("Stop Pre-training")
                tr_status = gr.Textbox(label="Pre-training Status", lines=10,
                                       interactive=False)
                tr_start.click(
                    backend.start_pretraining,
                    [tr_data, tr_val, tr_vocab, tr_params, tr_attn, tr_mm,
                     tr_moe, tr_ne, tr_ept, tr_flash, tr_imgdir, tr_maxlen,
                     tr_out, tr_bs, tr_lr, tr_epochs, tr_accum, tr_wandb],
                    [tr_status])
                tr_stop.click(lambda: backend.pretrain_job.stop(), outputs=[tr_status])

            with gr.TabItem("Fine-tuning"):
                ft_base = gr.Textbox(label="Pre-trained model dir/file")
                ft_data = gr.Textbox(label="Train data (JSONL instruction/output)")
                ft_val = gr.Textbox(label="Validation data (optional)")
                ft_hf = gr.Checkbox(label="Use HF tokenizer", value=True)
                ft_tok = gr.Textbox(label="Tokenizer name/path", value="gpt2")
                ft_tmpl = gr.Textbox(
                    label="Prompt template",
                    value="User: {instruction}\nAssistant: {output}")
                ft_maxlen = gr.Number(value=512, label="Max length")
                ft_out = gr.Textbox(label="Output dir", value="output_ft")
                ft_bs = gr.Number(value=4, label="Batch size")
                ft_lr = gr.Number(value=5e-5, label="Learning rate")
                ft_epochs = gr.Number(value=3, label="Epochs")
                ft_accum = gr.Number(value=4, label="Grad accumulation")
                ft_wandb = gr.Checkbox(label="Log to W&B")
                with gr.Row():
                    ft_start = gr.Button("Start Fine-tuning", variant="primary")
                    ft_stop = gr.Button("Stop Fine-tuning")
                ft_status = gr.Textbox(label="Fine-tuning Status", lines=10,
                                       interactive=False)
                ft_start.click(
                    backend.start_finetuning,
                    [ft_base, ft_data, ft_val, ft_hf, ft_tok, ft_tmpl,
                     ft_maxlen, ft_out, ft_bs, ft_lr, ft_epochs, ft_accum,
                     ft_wandb],
                    [ft_status])
                ft_stop.click(lambda: backend.finetune_job.stop(), outputs=[ft_status])

            with gr.TabItem("Absolute Zero Reasoner"):
                azr_tok = gr.Textbox(label="HF tokenizer", value="gpt2")
                azr_h = gr.Number(value=512, label="Hidden size")
                azr_l = gr.Number(value=8, label="Layers")
                azr_heads = gr.Number(value=8, label="Heads")
                azr_i = gr.Number(value=2048, label="Intermediate size")
                azr_attn = gr.Dropdown(["standard_mha", "selective_ssm"],
                                       value="standard_mha", label="Attention type")
                azr_iters = gr.Number(value=100, label="Iterations")
                azr_tasks = gr.Number(value=5, label="Tasks per iteration")
                azr_ckpt = gr.Number(value=10, label="Checkpoint interval")
                azr_out = gr.Textbox(label="Output dir", value="output_azr")
                with gr.Row():
                    azr_start = gr.Button("Start AZR Training", variant="primary")
                    azr_stop = gr.Button("Stop AZR Training")
                azr_status = gr.Textbox(label="AZR Training Status", lines=10,
                                        interactive=False)
                azr_start.click(
                    backend.start_azr,
                    [azr_tok, azr_h, azr_l, azr_heads, azr_i, azr_attn,
                     azr_iters, azr_tasks, azr_ckpt, azr_out],
                    [azr_status])
                azr_stop.click(lambda: backend.azr_job.stop(), outputs=[azr_status])

            with gr.TabItem("Models"):
                gr.Markdown("### Load model")
                load_path = gr.Textbox(label="Model dir or weights file")
                load_vocab = gr.Textbox(label="Vocab file override (optional)")
                load_btn = gr.Button("Load Model")
                load_info = gr.Textbox(label="Loaded Model Info", lines=8,
                                       interactive=False)
                load_btn.click(backend.load_model, [load_path, load_vocab],
                               [load_info])
                gr.Markdown("### Create model")
                new_params = gr.Textbox(label="Target parameters", value="125M")
                new_vocab = gr.Number(value=32000, label="Vocab size")
                new_mm = gr.Checkbox(label="Multimodal")
                new_moe = gr.Checkbox(label="Use Expert System")
                new_ne = gr.Number(value=8, label="Num experts")
                new_ept = gr.Number(value=2, label="Experts per token")
                new_attn = gr.Dropdown(["standard_mha", "selective_ssm"],
                                       value="standard_mha", label="Attention type")
                new_flash = gr.Checkbox(label="Use fused attention kernel")
                new_out = gr.Textbox(label="Output dir", value="models/new_model")
                create_btn = gr.Button("Create & Save New Model Files")
                create_status = gr.Textbox(label="Creation Status", lines=5,
                                           interactive=False)
                create_btn.click(
                    backend.create_model,
                    [new_params, new_vocab, new_mm, new_moe, new_ne, new_ept,
                     new_attn, new_flash, new_out],
                    [create_status])

    # Port fallback like the reference launcher.
    for attempt_port in range(port, port + 10):
        try:
            app.launch(server_name="0.0.0.0", server_port=attempt_port,
                       share=share)
            return
        except OSError:
            logger.warning("Port %d busy, trying %d", attempt_port,
                           attempt_port + 1)
    raise RuntimeError(f"No free port found in [{port}, {port + 10})")
