from .image_encoder import VIT_CONFIGS, ClipViT
from .model import ClipEBC, build_clip_ebc
from .prompts import bin_prompts, format_count, num2word
from .text_encoder import ClipTextEncoder
from .tokenizer import ClipTokenizer, get_tokenizer, tokenize
