#include "porter.h"

#include <array>
#include <cstring>
#include <utility>
#include <vector>

namespace clipcap_native {
namespace {

bool is_vowel_char(char c) { return c=='a'||c=='e'||c=='i'||c=='o'||c=='u'; }

bool is_consonant(const std::string& w, size_t i) {
    char c = w[i];
    if (is_vowel_char(c)) return false;
    if (c == 'y') return i == 0 || !is_consonant(w, i - 1);
    return true;
}

int measure(const std::string& stem) {
    int m = 0;
    bool prev_vowel = false;
    for (size_t i = 0; i < stem.size(); ++i) {
        bool cons = is_consonant(stem, i);
        if (prev_vowel && cons) ++m;
        prev_vowel = !cons;
    }
    return m;
}

bool has_vowel(const std::string& stem) {
    for (size_t i = 0; i < stem.size(); ++i)
        if (!is_consonant(stem, i)) return true;
    return false;
}

bool ends_double_consonant(const std::string& w) {
    size_t n = w.size();
    return n >= 2 && w[n-1] == w[n-2] && is_consonant(w, n-1);
}

bool ends_cvc(const std::string& w) {
    size_t n = w.size();
    if (n < 3) return false;
    char last = w[n-1];
    return is_consonant(w, n-3) && !is_consonant(w, n-2) && is_consonant(w, n-1)
        && last != 'w' && last != 'x' && last != 'y';
}

bool ends_with(const std::string& w, const char* suf) {
    size_t ls = std::strlen(suf);
    return w.size() >= ls && w.compare(w.size()-ls, ls, suf) == 0;
}

}  // namespace

std::string porter_stem(const std::string& word) {
    if (word.size() <= 2) return word;
    std::string w = word;

    // Step 1a
    if (ends_with(w, "sses")) w.resize(w.size()-2);
    else if (ends_with(w, "ies")) w.resize(w.size()-2);
    else if (ends_with(w, "ss")) { /* keep */ }
    else if (ends_with(w, "s")) w.resize(w.size()-1);

    // Step 1b
    if (ends_with(w, "eed")) {
        if (measure(w.substr(0, w.size()-3)) > 0) w.resize(w.size()-1);
    } else {
        bool flag = false;
        if (ends_with(w, "ed") && has_vowel(w.substr(0, w.size()-2))) {
            w.resize(w.size()-2); flag = true;
        } else if (ends_with(w, "ing") && has_vowel(w.substr(0, w.size()-3))) {
            w.resize(w.size()-3); flag = true;
        }
        if (flag) {
            if (ends_with(w, "at") || ends_with(w, "bl") || ends_with(w, "iz")) w += 'e';
            else if (ends_double_consonant(w) && w.back()!='l' && w.back()!='s' && w.back()!='z')
                w.resize(w.size()-1);
            else if (measure(w) == 1 && ends_cvc(w)) w += 'e';
        }
    }

    // Step 1c
    if (ends_with(w, "y") && has_vowel(w.substr(0, w.size()-1)))
        w[w.size()-1] = 'i';

    // Step 2
    static const std::vector<std::pair<const char*, const char*>> step2 = {
        {"ational","ate"},{"tional","tion"},{"enci","ence"},{"anci","ance"},
        {"izer","ize"},{"abli","able"},{"alli","al"},{"entli","ent"},
        {"eli","e"},{"ousli","ous"},{"ization","ize"},{"ation","ate"},
        {"ator","ate"},{"alism","al"},{"iveness","ive"},{"fulness","ful"},
        {"ousness","ous"},{"aliti","al"},{"iviti","ive"},{"biliti","ble"},
    };
    for (auto& [suf, rep] : step2) {
        if (ends_with(w, suf)) {
            std::string stem = w.substr(0, w.size()-std::strlen(suf));
            if (measure(stem) > 0) w = stem + rep;
            break;
        }
    }

    // Step 3
    static const std::vector<std::pair<const char*, const char*>> step3 = {
        {"icate","ic"},{"ative",""},{"alize","al"},{"iciti","ic"},
        {"ical","ic"},{"ful",""},{"ness",""},
    };
    for (auto& [suf, rep] : step3) {
        if (ends_with(w, suf)) {
            std::string stem = w.substr(0, w.size()-std::strlen(suf));
            if (measure(stem) > 0) w = stem + rep;
            break;
        }
    }

    // Step 4
    static const std::vector<const char*> step4 = {
        "al","ance","ence","er","ic","able","ible","ant","ement",
        "ment","ent","ou","ism","ate","iti","ous","ive","ize",
    };
    bool matched4 = false;
    for (auto* suf : step4) {
        if (ends_with(w, suf)) {
            std::string stem = w.substr(0, w.size()-std::strlen(suf));
            if (measure(stem) > 1) w = stem;
            matched4 = true;
            break;
        }
    }
    if (!matched4) {
        if (ends_with(w, "ion") && w.size() > 3) {
            char prev = w[w.size()-4];
            if ((prev=='s' || prev=='t') && measure(w.substr(0, w.size()-3)) > 1)
                w.resize(w.size()-3);
        }
    }

    // Step 5a
    if (ends_with(w, "e")) {
        std::string stem = w.substr(0, w.size()-1);
        int m = measure(stem);
        if (m > 1 || (m == 1 && !ends_cvc(stem))) w = stem;
    }

    // Step 5b
    if (measure(w) > 1 && ends_double_consonant(w) && w.back()=='l')
        w.resize(w.size()-1);

    return w;
}

}  // namespace clipcap_native
