from .gpt import (GPTConfig, GPTForCausalLM, GPTModel, gpt3_345m,  # noqa: F401
                  gpt_tiny)
from .llama import (LlamaConfig, LlamaForCausalLM, llama_7b,  # noqa: F401
                    llama_decode_params, llama_tiny, load_decode_params)
