from .merlin import Transcript
from .protocol import ProofTranscript
from .strobe import Strobe128
from .keccak import keccak_f1600

__all__ = ["Transcript", "ProofTranscript", "Strobe128", "keccak_f1600"]
