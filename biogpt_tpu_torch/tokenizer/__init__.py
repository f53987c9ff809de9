from .moses import moses_tokenize, moses_detokenize  # noqa: F401
from .bpe import BpeEncoder, get_pairs  # noqa: F401
from .tokenizer import BioGptTokenizer, BOS_EOS_ID  # noqa: F401
