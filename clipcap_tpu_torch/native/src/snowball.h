// Snowball English ("Porter2") stemmer — C++ port of
// clipcap_tpu_torch/eval/snowball.py (the behavioral spec; cross-tested).
#pragma once
#include <string>

namespace clipcap_native {
std::string snowball_stem(const std::string& word);
}
