"""``control.py`` with the ranking cells' faults (``rank_faults.py``) among
those ``--fault`` names:

    python3 perfbench/rank_control.py --workload yahoo-rank-refit \\
        --seeds 1,2,3 [--control-seeds 7,8] [--fault dropped_rows] ...

Every option is ``control.py``'s."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import control, faults, rank_faults  # noqa: E402

if __name__ == "__main__":
    faults.FAULTS.update(rank_faults.FAULTS)
    sys.exit(control.main())
