import sys
from pathlib import Path

# the port's sources, as the command puts them on the path itself
sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))
