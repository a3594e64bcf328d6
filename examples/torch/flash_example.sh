#!/usr/bin/env flash-torch
odgi depth -d -i tests/graphs/tiny.gfa
odgi depth -i tests/graphs/tiny.gfa
