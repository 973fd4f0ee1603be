from .ernie import (ErnieConfig, ErnieForMaskedLM,  # noqa: F401
                    ErnieForSequenceClassification, ErnieModel, ernie_tiny)
from .ernie_vil import (ErnieViLConfig, ErnieViLModel,  # noqa: F401
                        ernie_vil_base, ernie_vil_tiny)
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel, gpt3_345m,  # noqa: F401
                  gpt_tiny)
from .llama import (LlamaConfig, LlamaForCausalLM, llama_7b,  # noqa: F401
                    llama_13b, llama_decode_params, llama_tiny,
                    load_decode_params)
