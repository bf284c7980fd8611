"""One rank of the port's two-process data-parallel SFT step and engine
placement (``tests/test_torch_parallel.py``).

Each process drives two CPU slots; together they form a dp=2 × tp=2 mesh,
bootstrapped through ``MeshConfig`` (``EST_MESH__COORDINATOR`` /
``NUM_PROCESSES`` / ``PROCESS_ID``) as ``tests/_mp_worker.py`` bootstraps
the JAX package, but over ``torch.distributed`` (gloo). The initial
parameters and the batches come from an ``.npz`` the test writes (JAX's
initial tree, as numpy); jax and the JAX package are blocked from import.

Then each rank builds engines at toy widths over its two CPU slots (its
"cards"): ``torch_engines(stage_parallel=True)``, engines on the global
dp=2 × tp=2 mesh, and on stage meshes over all four global slots, and
reports where each tree landed.

Usage: python tests/_torch_mp_worker.py <coordinator_port> <rank> <inputs.npz>
Prints one JSON line with both steps' metrics and the placements.
"""

import importlib.abc
import json
import os
import sys


class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "expressive_speech_translation_tpu"):
            raise ImportError(f"{name} is blocked")


sys.meta_path.insert(0, _Block())
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _unflatten(flat: dict) -> dict:
    """``a/b/0/c`` keys → nested dicts, with digit keys as list items."""
    root: dict = {}
    for path, value in flat.items():
        node = root
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def _placement(mesh) -> dict:
    """Where this rank's engines put their trees: the slot ids of each
    stage's trees and the slots of a split leaf, for stage-parallel
    engines over this process's two slots, for engines on the global mesh,
    and whether an engine on another rank's slots is refused."""
    import torch

    from expressive_speech_translation_tpu_torch.models import cosyvoice as cv
    from expressive_speech_translation_tpu_torch.models import nllb, qwen2, whisper
    from expressive_speech_translation_tpu_torch.parallel import mesh as pmesh
    from expressive_speech_translation_tpu_torch.parallel.stages import stage_meshes
    from expressive_speech_translation_tpu_torch.pipeline.torch_engines import (
        TorchNllbNmt, torch_engines)

    pmesh.local_devices = lambda: [torch.device("cpu")] * 2     # this process's two "cards"
    tiny = dict(
        device="cpu", dtype=torch.float32, asr_context_buckets=(4,),
        asr_cfg=whisper.WhisperConfig(n_mels=80, d_model=64, encoder_layers=1, decoder_layers=1,
                                      heads=4, ffn_dim=128),
        nmt_cfg=nllb.NLLBConfig(d_model=64, encoder_layers=1, decoder_layers=1, heads=4,
                                ffn_dim=128, vocab_size=384),
        tts_cfg=cv.CosyVoiceConfig(
            lm=cv.SpeechLMConfig(backbone=qwen2.Qwen2Config(hidden=32, layers=1, heads=4,
                                                            kv_heads=2, ffn_dim=64,
                                                            max_positions=512),
                                 text_vocab=128, speech_token_size=61),
            flow=cv.FlowConfig(token_vocab=64, dim=32, layers=1, heads=4, n_steps=2),
            vocoder=cv.VocoderConfig(base_channels=32)))
    staged = torch_engines(stage_parallel=True, **tiny)
    meshed = torch_engines(mesh=mesh, **tiny)
    q = meshed.nmt.params["decoder"]["layers"][0]["self_attn"]["q"]["kernel"]
    refused = {}
    for stage, m in stage_meshes(devices=mesh.devices.flat).items():
        try:
            TorchNllbNmt(tiny["nmt_cfg"], device="cpu", dtype=torch.float32, mesh=m)
            refused[stage] = False
        except ValueError:
            refused[stage] = True
    return {"staged": staged.placement_info(), "meshed": meshed.placement_info(),
            "meshed_groups": len(meshed.nmt.groups), "meshed_q_slots": list(q.slots),
            "refused": refused}


def main() -> int:
    port, rank, inputs = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    os.environ["EST_MESH__COORDINATOR"] = f"127.0.0.1:{port}"
    os.environ["EST_MESH__NUM_PROCESSES"] = "2"
    os.environ["EST_MESH__PROCESS_ID"] = str(rank)

    import numpy as np
    import torch

    from expressive_speech_translation_tpu_torch.core.config import load_config
    from expressive_speech_translation_tpu_torch.models import cosyvoice as cv
    from expressive_speech_translation_tpu_torch.models import qwen2 as q2
    from expressive_speech_translation_tpu_torch.models.common import tree_from_numpy
    from expressive_speech_translation_tpu_torch.parallel.mesh import (
        MeshSpec, global_slots, make_mesh, maybe_initialize_distributed)
    from expressive_speech_translation_tpu_torch.train import sft

    maybe_initialize_distributed(load_config().mesh)
    data = np.load(inputs)
    lm_cfg = cv.SpeechLMConfig(
        backbone=q2.Qwen2Config(hidden=64, layers=2, heads=4, kv_heads=2, ffn_dim=128,
                                max_positions=256),
        text_vocab=97, speech_token_size=61)
    params = tree_from_numpy(_unflatten({k[len("p/"):]: data[k] for k in data.files
                                         if k.startswith("p/")}), "cpu", torch.float32)
    mesh = make_mesh(MeshSpec(dp=2, tp=2), devices=global_slots(["cpu", "cpu"]))
    opt = sft.make_optimizer(1e-4, grad_clip=5.0, weight_decay=1e-4)
    state = sft.init_train_state(0, lm_cfg, opt, params=params)
    step = sft.make_train_step(lm_cfg, opt, mesh, accum_grad=2, compute_dtype=torch.float32)
    steps = []
    for i in range(2):
        batch = sft.SFTBatch(*(data[f"b{i}/{k}"] for k in sft.SFTBatch._fields))
        state, m = step(state, batch)
        steps.append({k: float(v) for k, v in m.items()})
    placement = _placement(mesh)
    print(json.dumps({
        "rank": rank, "steps": steps, "placement": placement,
        "world": torch.distributed.get_world_size(),
        "mesh_shape": dict(mesh.shape), "local_groups": mesh.local_groups(),
        "jax_imported": any(m.split(".")[0] in ("jax", "expressive_speech_translation_tpu")
                            for m in sys.modules),
    }), flush=True)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
