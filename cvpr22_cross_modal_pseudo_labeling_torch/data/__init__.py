from .build import make_data_loader
from .collate import BatchCollator, HashingTokenizer
from .parser import LVISParser, get_parser, normalize_class_names
from .transforms import build_transforms
