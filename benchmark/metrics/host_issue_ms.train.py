"""The host time for one train-step call to return, the card idle before
it: the median of the calls timed after the window, in ms."""

import statistics


def read(records):
    issue = records.get("host_issue_ms") if records.get("kind") == "train" \
        else None
    return statistics.median(issue) if issue else None
