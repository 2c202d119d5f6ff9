from huggingface_asr_tpu_torch.decoding.beam_search import BeamSearchConfig, joint_beam_search
from huggingface_asr_tpu_torch.decoding.ctc_prefix import CTCPrefixScorer, CTCPrefixState

__all__ = ["CTCPrefixScorer", "CTCPrefixState", "BeamSearchConfig", "joint_beam_search"]
