#!/bin/bash
# Collision-gap forensics: seed-matched parity matrix across formulation
# variants, run one after another on one device. Run from the repo root.
set -x
P=python
$P scripts/parity_seedmatch.py --out results/parity_r5/v0_baseline \
    2>&1 | tail -12
$P scripts/parity_seedmatch.py --no-status4 \
    --out results/parity_r5/v1_nostatus4 2>&1 | tail -12
$P scripts/parity_seedmatch.py --slack-unscaled \
    --out results/parity_r5/v2_slackraw 2>&1 | tail -12
$P scripts/parity_seedmatch.py --slack-unscaled --no-status4 \
    --out results/parity_r5/v3_slackraw_nostatus4 2>&1 | tail -12
$P scripts/parity_seedmatch.py --cost-unscaled --no-status4 \
    --out results/parity_r5/v4_costraw_nostatus4 2>&1 | tail -12
$P scripts/parity_seedmatch.py --lm-raw --no-status4 \
    --out results/parity_r5/v5_lmraw_nostatus4 2>&1 | tail -12
echo ABLATIONS_DONE
