#!/bin/sh
# Windowed depth along a path on the PyTorch port (counterpart of
# examples/windows.sh; reference: flatgfa-sh/windows.sh). Run from the
# repository root with flash-torch/fgfa-torch on PATH; $1 is the device
# (cuda, the default, or cpu). The BED windows go to a temporary file.
set -e
device=${1:-cuda}
bed=$(mktemp)
trap 'rm -f "$bed"' EXIT
flash-torch --device "$device" -O -c 'odgi depth -i tests/graphs/tiny.gfa -r alpha | bedtools makewindows -b /dev/stdin -w 4' > "$bed" < /dev/null
fgfa-torch --device "$device" -I tests/graphs/tiny.gfa depth -b "$bed"
