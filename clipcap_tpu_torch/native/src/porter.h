// Porter stemming algorithm (Porter, 1980) — C++ twin of
// clipcap_tpu_torch/eval/porter.py (the behavioral spec; cross-tested for
// identical output).
#pragma once
#include <string>

namespace clipcap_native {
std::string porter_stem(const std::string& word);
}
