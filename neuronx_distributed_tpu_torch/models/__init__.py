"""Model families of the PyTorch port: Llama and Mixtral (trained and
served), GPT-NeoX, BERT and ViT (trained; ViT also served through
``inference.model_builder``). :func:`family_of` maps a config to its
module and model class.

Names resolve at first use (PEP 562): the Llama module imports the
inference package's caches, whose engine imports the models.
"""

import importlib

_NAMES = {
    "llama": ("LLAMA2_7B", "LLAMA2_70B", "LLAMA3_8B", "LlamaConfig",
              "LlamaForCausalLM", "tiny_config"),
    "mixtral": ("DBRX", "MIXTRAL_8X7B", "MixtralConfig",
                "MixtralForCausalLM", "tiny_moe_config"),
    "gpt_neox": ("GPT_NEOX_20B", "GPTNeoXConfig", "GPTNeoXForCausalLM",
                 "tiny_neox_config"),
    "bert": ("BERT_LARGE", "BertConfig", "BertForPreTraining",
             "tiny_bert_config"),
    "vit": ("VIT_BASE", "VIT_HUGE", "VIT_LARGE", "ViTConfig",
            "ViTForImageClassification", "patchify", "tiny_vit_config"),
}
_WHERE = {name: mod for mod, names in _NAMES.items() for name in names}

__all__ = sorted(_WHERE) + ["family_of"]


def family_of(cfg):
    """``(module, model class)`` of the family ``cfg`` configures (a
    ``MixtralConfig`` is Mixtral, though it subclasses ``LlamaConfig``)."""
    from . import bert, gpt_neox, llama, mixtral, vit

    for config, module, cls in (
            (mixtral.MixtralConfig, mixtral, mixtral.MixtralForCausalLM),
            (llama.LlamaConfig, llama, llama.LlamaForCausalLM),
            (gpt_neox.GPTNeoXConfig, gpt_neox, gpt_neox.GPTNeoXForCausalLM),
            (bert.BertConfig, bert, bert.BertForPreTraining),
            (vit.ViTConfig, vit, vit.ViTForImageClassification)):
        if isinstance(cfg, config):
            return module, cls
    raise TypeError(f"no model family for {type(cfg).__name__}")


def __getattr__(name):
    if name in _WHERE:
        return getattr(importlib.import_module(f".{_WHERE[name]}", __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
