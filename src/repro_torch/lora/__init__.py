from repro_torch.lora.adapters import (LoRAAdapter, init_lora, merge_lora,
                                       randomize_lora, unmerge_lora)

__all__ = ["LoRAAdapter", "init_lora", "randomize_lora", "merge_lora",
           "unmerge_lora"]
