from .air import AIRDecoder, AIREncoder
from .core import HIDDEN_OUTPUT_FIELDS, DiscoveryCore, PropagationCore
from .discover import Discover
from .model import Model
from .propagate import Propagate, PropagatePrior
from .seq import SequentialAIR
from .timestep import SQAIRTimestep
