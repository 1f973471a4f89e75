#!/usr/bin/env python
"""End-to-end quality evaluation: train a tiny Apertis on a deterministic
synthetic corpus, then score it with the evaluation harness (`apertis eval`).

The corpus is word-arithmetic ("question : what is three plus four ? answer :
seven ."): every arithmetic fact with operands 0..10 and a result in 0..20 is
rendered through several sentence templates. The train/val split holds out
whole (fact, template) pairs, so validation perplexity measures generalisation
across templates, and the multiple-choice set (4 number-word choices per
question, 25% chance) measures whether the model actually learned the facts
rather than surface statistics.

This exercises the same user path as the reference's quality rows
(/root/reference/docs/README.md:568-580): data -> train_from_config ->
checkpoint -> `apertis eval` perplexity + multiple_choice. Everything is
seeded; re-running reproduces the dataset bit-for-bit.

Usage:
    python examples/quality_eval.py [--workdir /tmp/apertis_quality] \
        [--epochs 30] [--platform cpu|cuda]
"""

from __future__ import annotations

import argparse
import itertools
import json
import random
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

NUMBER_WORDS = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen", "twenty",
]
OPS = {"plus": lambda a, b: a + b,
       "minus": lambda a, b: a - b,
       "times": lambda a, b: a * b}
TEMPLATES = [
    "question : what is {a} {op} {b} ? answer : {c} .",
    "what is {a} {op} {b} ? it is {c} .",
    "{a} {op} {b} is {c} .",
    "compute {a} {op} {b} : the result is {c} .",
]
MC_PROMPT = "question : what is {a} {op} {b} ? answer :"


def all_facts():
    """Every (a, op, b, result) with operands 0..10 and result in 0..20."""
    for op, fn in OPS.items():
        for a, b in itertools.product(range(11), range(11)):
            c = fn(a, b)
            if 0 <= c <= 20:
                yield (a, op, b, c)


def render(template: str, fact) -> str:
    a, op, b, c = fact
    return template.format(a=NUMBER_WORDS[a], op=op, b=NUMBER_WORDS[b],
                           c=NUMBER_WORDS[c])


def build_vocab() -> dict:
    words = sorted({w for t in TEMPLATES for w in t.split()
                    if not w.startswith("{")}
                   | set(NUMBER_WORDS) | set(OPS))
    vocab = {"<pad>": 0, "<bos>": 1, "<eos>": 2, "<unk>": 3}
    for i, w in enumerate(words):
        vocab[w] = 4 + i
    return vocab


def make_dataset(workdir: Path, seed: int = 0):
    rng = random.Random(seed)
    facts = list(all_facts())
    pairs = [(f, t) for f in facts for t in range(len(TEMPLATES))]
    rng.shuffle(pairs)

    # Hold out ~10% of (fact, template) pairs for validation, but keep every
    # fact present in train under at least one template.
    val, train, seen_in_train = [], [], set()
    for f, t in pairs:
        if len(val) < len(pairs) // 10 and f in seen_in_train:
            val.append((f, t))
        else:
            train.append((f, t))
            seen_in_train.add(f)

    # Multiple choice: 60 facts asked through the question template, choices
    # are the answer plus three nearby distractor number words.
    mc_items = []
    for f in rng.sample(facts, 60):
        a, op, b, c = f
        distractors = rng.sample([n for n in range(21) if n != c], 3)
        choices = [NUMBER_WORDS[c]] + [NUMBER_WORDS[d] for d in distractors]
        order = list(range(4))
        rng.shuffle(order)
        mc_items.append({
            "question": MC_PROMPT.format(a=NUMBER_WORDS[a], op=op,
                                         b=NUMBER_WORDS[b]),
            "choices": [choices[i] for i in order],
            "answer": order.index(0),
        })

    workdir.mkdir(parents=True, exist_ok=True)
    with open(workdir / "train.jsonl", "w") as fh:
        for f, t in train:
            fh.write(json.dumps({"text": render(TEMPLATES[t], f)}) + "\n")
    with open(workdir / "val.jsonl", "w") as fh:
        for f, t in val:
            fh.write(json.dumps({"text": render(TEMPLATES[t], f)}) + "\n")
    with open(workdir / "mc.jsonl", "w") as fh:
        for item in mc_items:
            fh.write(json.dumps(item) + "\n")
    with open(workdir / "vocab.json", "w") as fh:
        json.dump(build_vocab(), fh, indent=2)
    return len(train), len(val), len(mc_items)


def write_config(workdir: Path, epochs: int,
                 attention_type: str = "selective_ssm",
                 moe: bool = False) -> Path:
    cfg = {
        "data_config": {
            "train_data_path": str(workdir / "train.jsonl"),
            "val_data_path": str(workdir / "val.jsonl"),
            "tokenizer_path": str(workdir / "vocab.json"),
            "max_length": 32,
        },
        "model_config": {
            "target_param_count": "2M",
            "attention_type": attention_type,
            "ssm_d_state": 16,
            "use_expert_system": moe,
            "num_experts": 4,
            "experts_per_token": 2,
            "config_overrides": {"use_rmsnorm": True,
                                 "use_swiglu": not moe},
        },
        "training_config": {
            "task_type": "pretrain",
            "output_dir": str(workdir / "out"),
            "batch_size": 32,
            "learning_rate": 1e-3,
            "num_epochs": epochs,
            "gradient_accumulation_steps": 1,
            "bf16": False,  # tiny model: fp32 is cheap and stabler at high lr
            "eval_every_n_epochs": max(1, epochs // 3),
            "seed": 0,
        },
    }
    path = workdir / "train_config.json"
    path.write_text(json.dumps(cfg, indent=2))
    return path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default="/tmp/apertis_quality")
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--platform", default=None, choices=[None, "cpu", "cuda"])
    ap.add_argument("--attention", default="selective_ssm",
                    choices=["selective_ssm", "standard_mha"])
    ap.add_argument("--moe", action="store_true",
                    help="use the mixture-of-experts FFN")
    args = ap.parse_args()

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    workdir = Path(args.workdir)
    n_train, n_val, n_mc = make_dataset(workdir)
    print(f"dataset: {n_train} train / {n_val} val sentences, {n_mc} MC items")

    cfg_path = write_config(workdir, args.epochs, args.attention,
                            moe=args.moe)

    from apertis_llm_tpu.evaluation import run_eval
    from apertis_llm_tpu.training.pipeline import train_from_config

    train_from_config(str(cfg_path))

    ckpt = workdir / "out" / "final"
    ppl = run_eval(str(ckpt), str(workdir / "val.jsonl"), task="perplexity")
    mc = run_eval(str(ckpt), str(workdir / "mc.jsonl"),
                  task="multiple_choice", prompt_template="{question}")
    summary = {"val_perplexity": round(ppl["perplexity"], 3),
               "val_tokens": ppl["tokens"],
               "mc_accuracy": round(mc["accuracy"], 3),
               "mc_accuracy_norm": round(mc["accuracy_norm"], 3),
               "mc_items": mc["items"]}
    print(json.dumps(summary, indent=2))
    (workdir / "eval_results.json").write_text(json.dumps(summary, indent=2))


if __name__ == "__main__":
    main()
