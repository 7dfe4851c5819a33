"""Text encoders: T5 v1.1 (prompt embeds) and the CLIP text tower (pooled);
the speech path's Whisper ASR and Marian zh->en translator."""

from loongx_tpu_torch.models.text.t5 import (  # noqa: F401
    T5Config, init_t5_params, t5_encode,
)
from loongx_tpu_torch.models.text.clip import (  # noqa: F401
    CLIPTextConfig,
    init_clip_params,
    clip_encode,
)
from loongx_tpu_torch.models.text.whisper import (  # noqa: F401
    WhisperASR,
    WhisperConfig,
    init_whisper_params,
    whisper_encode,
    whisper_greedy_decode,
)
from loongx_tpu_torch.models.text.marian import (  # noqa: F401
    MarianConfig,
    MarianTranslator,
    init_marian_params,
    marian_encode,
    marian_greedy_decode,
)
