#!/bin/bash
# Stall-resilient runner for long training jobs.
#
# A long run can stop making progress (the process blocks, its log stops,
# the device idles).  This supervisor launches a *resumable* training command (it must be
# idempotent under relaunch, i.e. save_and_load.save_model=True +
# load_model=True), watches a set of paths for output progress, and if
# nothing has been written for STALL seconds kills the run by PID (never by
# pattern) and relaunches it.  Recovery is exact: resume is
# bitwise-deterministic (tests/test_trainer.py::test_track_mode_mid_run_resume_is_exact).
#
# usage: supervise.sh LOG "WATCH_PATH [WATCH_PATH...]" STALL_S MAX_ATTEMPTS -- cmd...
set -u

LOG="$1"; WATCH="$2"; STALL="$3"; MAX_ATTEMPTS="$4"; shift 4
[ "$1" = "--" ] && shift
POLL="${SUPERVISE_POLL:-60}"  # seconds between liveness checks

newest_mtime() {
  # newest mtime (epoch s) across the log and all watch paths; 0 if none
  { stat -c %Y "$LOG" 2>/dev/null
    for p in $WATCH; do
      find "$p" -type f -printf '%T@\n' 2>/dev/null
    done
  } | sort -rn | head -1 | cut -d. -f1
}

attempt=0
while [ "$attempt" -lt "$MAX_ATTEMPTS" ]; do
  attempt=$((attempt + 1))
  echo "[supervise] attempt $attempt: $*" >> "$LOG"
  "$@" >> "$LOG" 2>&1 &
  PID=$!
  while true; do
    sleep "$POLL"
    if ! kill -0 "$PID" 2>/dev/null; then
      wait "$PID"
      rc=$?
      if [ "$rc" -eq 0 ]; then
        echo "[supervise] attempt $attempt finished OK" >> "$LOG"
        exit 0
      fi
      echo "[supervise] attempt $attempt exited rc=$rc; relaunching" >> "$LOG"
      break
    fi
    last=$(newest_mtime); now=$(date +%s)
    if [ -n "$last" ] && [ $((now - last)) -gt "$STALL" ]; then
      echo "[supervise] stall: no output for $((now - last))s, killing $PID" >> "$LOG"
      kill -TERM "$PID" 2>/dev/null
      sleep 20
      kill -KILL "$PID" 2>/dev/null
      wait "$PID" 2>/dev/null
      break
    fi
  done
done
echo "[supervise] giving up after $MAX_ATTEMPTS attempts" >> "$LOG"
exit 1
