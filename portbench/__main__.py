import sys
import time

STARTED = time.perf_counter()

from portbench.run import main  # noqa: E402

sys.exit(main(started=STARTED))
