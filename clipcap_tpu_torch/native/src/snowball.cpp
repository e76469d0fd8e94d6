// Snowball English ("Porter2") stemmer — C++ port of
// clipcap_tpu_torch/eval/snowball.py, which implements the published algorithm
// (snowballstem.org "The English (Porter2) stemming algorithm") with
// position-based regions like the reference tartarus implementations.
#include "snowball.h"

#include <algorithm>
#include <array>
#include <cctype>
#include <map>

namespace clipcap_native {
namespace {

const std::string VOWELS = "aeiouy";

bool is_vowel_char(char c) { return VOWELS.find(c) != std::string::npos; }
bool is_vowel(const std::string& w, size_t i) { return is_vowel_char(w[i]); }

bool ends_with(const std::string& w, const std::string& suf) {
    return w.size() >= suf.size() &&
           w.compare(w.size() - suf.size(), suf.size(), suf) == 0;
}

const std::map<std::string, std::string>& exceptions() {
    static const std::map<std::string, std::string> m = {
        {"skis", "ski"}, {"skies", "sky"},
        {"dying", "die"}, {"lying", "lie"}, {"tying", "tie"},
        {"idly", "idl"}, {"gently", "gentl"}, {"ugly", "ugli"},
        {"early", "earli"}, {"only", "onli"}, {"singly", "singl"},
        {"sky", "sky"}, {"news", "news"}, {"howe", "howe"},
        {"atlas", "atlas"}, {"cosmos", "cosmos"}, {"bias", "bias"},
        {"andes", "andes"},
    };
    return m;
}

bool is_post_1a_exception(const std::string& w) {
    static const char* words[] = {"inning", "outing", "canning", "herring",
                                  "earring", "proceed", "exceed", "succeed"};
    for (auto* s : words)
        if (w == s) return true;
    return false;
}

bool ends_double(const std::string& w) {
    static const char* doubles[] = {"bb", "dd", "ff", "gg", "mm",
                                    "nn", "pp", "rr", "tt"};
    for (auto* d : doubles)
        if (ends_with(w, d)) return true;
    return false;
}

void regions(const std::string& w, size_t* r1, size_t* r2) {
    *r1 = w.size();
    static const char* prefixes[] = {"gener", "commun", "arsen"};
    bool special = false;
    for (auto* p : prefixes) {
        std::string pre(p);
        if (w.compare(0, pre.size(), pre) == 0 && w.size() >= pre.size()) {
            *r1 = pre.size();
            special = true;
            break;
        }
    }
    if (!special) {
        for (size_t i = 1; i < w.size(); ++i) {
            if (!is_vowel(w, i) && is_vowel(w, i - 1)) { *r1 = i + 1; break; }
        }
    }
    *r2 = w.size();
    for (size_t i = *r1 + 1; i < w.size(); ++i) {
        if (!is_vowel(w, i) && is_vowel(w, i - 1)) { *r2 = i + 1; break; }
    }
}

bool ends_short_syllable(const std::string& w) {
    size_t n = w.size();
    if (n == 2) return is_vowel(w, 0) && !is_vowel(w, 1);
    if (n >= 3) {
        char last = w[n - 1];
        return is_vowel(w, n - 2) && !is_vowel(w, n - 3) && !is_vowel(w, n - 1)
               && last != 'w' && last != 'x' && last != 'Y';
    }
    return false;
}

bool is_short(const std::string& w, size_t r1) {
    return r1 >= w.size() && ends_short_syllable(w);
}

bool has_vowel(const std::string& w, size_t end) {
    for (size_t i = 0; i < std::min(end, w.size()); ++i)
        if (is_vowel(w, i)) return true;
    return false;
}

}  // namespace

std::string snowball_stem(const std::string& word) {
    std::string w;
    w.reserve(word.size());
    for (char c : word) w.push_back(static_cast<char>(std::tolower(
        static_cast<unsigned char>(c))));

    auto it = exceptions().find(w);
    if (it != exceptions().end()) return it->second;
    if (w.size() <= 2) return w;
    if (w[0] == '\'') w.erase(0, 1);

    // Mark consonant-y as Y.
    if (!w.empty() && w[0] == 'y') w[0] = 'Y';
    for (size_t i = 1; i < w.size(); ++i)
        if (w[i] == 'y' && is_vowel_char(w[i - 1])) w[i] = 'Y';

    size_t r1, r2;
    regions(w, &r1, &r2);

    // Step 0
    for (const char* suf : {"'s'", "'s", "'"}) {
        if (ends_with(w, suf)) { w.resize(w.size() - std::string(suf).size()); break; }
    }

    // Step 1a
    if (ends_with(w, "sses")) {
        w.resize(w.size() - 2);
    } else if (ends_with(w, "ied") || ends_with(w, "ies")) {
        w.resize(w.size() - (w.size() > 4 ? 2 : 1));
    } else if (ends_with(w, "us") || ends_with(w, "ss")) {
        // keep
    } else if (ends_with(w, "s")) {
        if (w.size() >= 2 && has_vowel(w, w.size() - 2)) w.resize(w.size() - 1);
    }

    if (is_post_1a_exception(w)) {
        std::replace(w.begin(), w.end(), 'Y', 'y');
        return w;
    }

    // Step 1b
    if (ends_with(w, "eedly") || ends_with(w, "eed")) {
        size_t n = ends_with(w, "eedly") ? 5 : 3;
        if (w.size() - n >= r1) { w.resize(w.size() - n); w += "ee"; }
    } else {
        for (const std::string suf : {"ingly", "edly", "ing", "ed"}) {
            if (!ends_with(w, suf)) continue;
            std::string stem = w.substr(0, w.size() - suf.size());
            if (has_vowel(stem, stem.size())) {
                w = stem;
                if (ends_with(w, "at") || ends_with(w, "bl") || ends_with(w, "iz"))
                    w += 'e';
                else if (ends_double(w))
                    w.resize(w.size() - 1);
                else if (is_short(w, r1))
                    w += 'e';
            }
            break;
        }
    }

    // Step 1c
    if (w.size() > 2 && (w.back() == 'y' || w.back() == 'Y')
        && !is_vowel_char(w[w.size() - 2]))
        w.back() = 'i';

    // Step 2 (in R1)
    {
        struct Rule { const char* suf; const char* rep; };
        static const Rule rules[] = {
            {"ization", "ize"}, {"ational", "ate"}, {"ousness", "ous"},
            {"iveness", "ive"}, {"fulness", "ful"}, {"tional", "tion"},
            {"biliti", "ble"}, {"lessli", "less"}, {"entli", "ent"},
            {"ation", "ate"}, {"alism", "al"}, {"aliti", "al"},
            {"ousli", "ous"}, {"iviti", "ive"}, {"fulli", "ful"},
            {"enci", "ence"}, {"anci", "ance"}, {"abli", "able"},
            {"izer", "ize"}, {"ator", "ate"}, {"alli", "al"},
            {"bli", "ble"}, {"ogi", "og"}, {"li", ""},
        };
        for (const auto& rule : rules) {
            std::string suf(rule.suf);
            if (!ends_with(w, suf)) continue;
            if (w.size() - suf.size() >= r1) {
                if (suf == "ogi") {
                    if (ends_with(w, "logi")) w.resize(w.size() - 1);
                } else if (suf == "li") {
                    static const std::string li_valid = "cdeghkmnrt";
                    if (w.size() >= 3 &&
                        li_valid.find(w[w.size() - 3]) != std::string::npos)
                        w.resize(w.size() - 2);
                } else {
                    w.resize(w.size() - suf.size());
                    w += rule.rep;
                }
            }
            break;
        }
    }

    // Step 3 (in R1; 'ative' requires R2)
    {
        struct Rule { const char* suf; const char* rep; };
        static const Rule rules[] = {
            {"ational", "ate"}, {"tional", "tion"}, {"alize", "al"},
            {"icate", "ic"}, {"iciti", "ic"}, {"ative", ""},
            {"ical", "ic"}, {"ness", ""}, {"ful", ""},
        };
        for (const auto& rule : rules) {
            std::string suf(rule.suf);
            if (!ends_with(w, suf)) continue;
            if (w.size() - suf.size() >= r1) {
                if (suf == "ative") {
                    if (w.size() - suf.size() >= r2) w.resize(w.size() - suf.size());
                } else {
                    w.resize(w.size() - suf.size());
                    w += rule.rep;
                }
            }
            break;
        }
    }

    // Step 4 (in R2)
    {
        static const char* sufs[] = {"ement", "ance", "ence", "able", "ible",
                                     "ment", "ant", "ent", "ism", "ate", "iti",
                                     "ous", "ive", "ize", "ion", "al", "er", "ic"};
        for (const char* s : sufs) {
            std::string suf(s);
            if (!ends_with(w, suf)) continue;
            if (w.size() - suf.size() >= r2) {
                if (suf == "ion") {
                    if (w.size() >= 4 && (w[w.size() - 4] == 's' || w[w.size() - 4] == 't'))
                        w.resize(w.size() - 3);
                } else {
                    w.resize(w.size() - suf.size());
                }
            }
            break;
        }
    }

    // Step 5
    if (!w.empty() && w.back() == 'e') {
        std::string stem = w.substr(0, w.size() - 1);
        if (stem.size() >= r2 ||
            (stem.size() >= r1 && !ends_short_syllable(stem)))
            w = stem;
    } else if (ends_with(w, "ll") && w.size() - 1 >= r2) {
        w.resize(w.size() - 1);
    }

    std::replace(w.begin(), w.end(), 'Y', 'y');
    return w;
}

}  // namespace clipcap_native
