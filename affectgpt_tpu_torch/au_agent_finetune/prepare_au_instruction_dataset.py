"""Build the AU-Agent SFT dataset from MER-Factory outputs.

    python -m affectgpt_tpu_torch.au_agent_finetune.prepare_au_instruction_dataset \
        --mer-factory-output <dir> [--save-path au_instruction_dataset.json]

Port of the repo's root au_agent_finetune/prepare_au_instruction_dataset.py
(reference: au_agent_finetune/prepare_au_instruction_dataset.py): walk the
MER-Factory output tree, read each `{name}_au_analysis.json`, pair the
detected AU intensities with the human/LLM `summary_description`, and
emit instruction-tuning records: a JSON list of {"system", "user",
"assistant"} turns consumed by train_au_agent (the port's own LoRA SFT
path). Host only.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from affectgpt_tpu_torch.models.au_agent import INSTRUCTION, build_au_input


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--mer-factory-output", required=True)
    parser.add_argument("--save-path", default="au_instruction_dataset.json")
    parser.add_argument("--threshold", type=float, default=0.5)
    args = parser.parse_args(argv)

    records = []
    for json_path in sorted(
        glob.glob(os.path.join(args.mer_factory_output, "*", "*_au_analysis.json"))
    ):
        with open(json_path) as handle:
            data = json.load(handle)
        au_info = data.get("au_info") or {}
        frames = au_info.get("frames") or [au_info] if au_info else []
        for frame in frames:
            aus = frame.get("au_values") or frame.get("aus")
            target = frame.get("summary_description") or data.get("summary_description")
            if not aus or not target:
                continue
            user_text = build_au_input(aus, threshold=args.threshold)
            if user_text is None:
                continue
            records.append(
                {"system": INSTRUCTION, "user": user_text, "assistant": target}
            )

    with open(args.save_path, "w") as handle:
        json.dump(records, handle, indent=1, ensure_ascii=False)
    print(f"wrote {len(records)} SFT records to {args.save_path}")


if __name__ == "__main__":
    main()
